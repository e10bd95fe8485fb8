"""PyTorch/CUDA port of crb_active_3ddet_tpu.

The JAX package ``crb_active_3ddet_tpu`` is the reference; this package runs
the same functions in PyTorch, with the JAX package's Pallas kernels as
hand-written CUDA kernels for Hopper (``csrc/``).  Entry points run on the
card unless the caller passes ``device='cpu'``.
"""
