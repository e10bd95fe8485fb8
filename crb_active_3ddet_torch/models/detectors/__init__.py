from .detector3d import Detector3D, build_detector, init_weights  # noqa: F401
