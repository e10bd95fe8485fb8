"""Sparse 3D convolution: sort-built rulebooks + gather-GEMM (torch).

Replaces spconv (``pcdet/utils/spconv_utils.py``) like the JAX package's
``ops/sparse``: rulebooks come from sorts over voxel cell ids and each conv
layer is one gather-GEMM over fixed-capacity padded voxel sets.
"""

from .rulebook import (conv_out_grid, downsample_rulebook,  # noqa: F401
                       inverse_rulebook, subm_rulebook_window,
                       unpack_window_rulebook)
from .sparse_ops import (gather_gemm_dgrad_plain,  # noqa: F401
                         gather_gemm_wgrad_plain, sparse_tensor_to_dense,
                         subm_conv3d_gather)
