from .detector3d import Detector3D, build_detector, flax_init, init_weights  # noqa: F401
