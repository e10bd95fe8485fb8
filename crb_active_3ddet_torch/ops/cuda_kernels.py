"""Sparse-conv gather-GEMM: wrapper of the CUDA kernel ``csrc/gather_gemm.cu``.

Counterpart of ``crb_active_3ddet_tpu/ops/pallas_kernels.py:60
sparse_conv_gather_gemm``: ``out[v] = Σ_k feat[rulebook[v, k]] @ W[k]`` with
−1 meaning no neighbour, accumulated in f32.  Every sparse conv layer of
``VoxelBackBone8x`` runs it.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU tensors
it runs the plain version, ``ops.sparse.sparse_ops.subm_conv3d_gather``.
bf16 operands run on tensor cores (``mma.sync``), f32 operands on CUDA cores
in full f32; both skip the offsets without a hit.
``launches`` counts the wrapper's calls that reached the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .sparse.sparse_ops import subm_conv3d_gather

launches = 0

_SIG = {'gather_gemm_launch': [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]}
SUPPORTED_CIN = (4, 8, 16, 32, 64)
MAX_K = 32               # offsets a rulebook row may hold (the kernel's mask)


def supported_cout(cout):
    return cout in (16, 32) or (cout > 0 and cout % 64 == 0)


def sparse_conv_gather_gemm(features, rulebook, weights):
    """features (V_in, Cin) f32 or bf16; rulebook (V_out, K) int32 (−1 =
    none, else a row of ``features``); weights (K, Cin, Cout) of the
    features' dtype.  Returns (V_out, Cout) float32."""
    if features.device.type == 'cpu':
        return subm_conv3d_gather(features, rulebook, weights)
    return _launch(features, rulebook, weights)


def _launch(features, rulebook, weights):
    global launches
    v_out, k = rulebook.shape
    cin = features.shape[1]
    cout = weights.shape[2]
    dev = features.device
    if dev.type != 'cuda' or rulebook.device != dev or weights.device != dev:
        raise ValueError('gather-GEMM: all tensors must be on one CUDA device')
    if features.dtype not in (torch.float32, torch.bfloat16) \
            or weights.dtype != features.dtype:
        raise TypeError('gather-GEMM: features and weights must both be '
                        f'f32 or both bf16, got {features.dtype}, '
                        f'{weights.dtype}')
    if rulebook.dtype != torch.int32:
        raise TypeError(f'gather-GEMM: rulebook must be int32, got {rulebook.dtype}')
    if features.ndim != 2 or weights.shape[:2] != (k, cin):
        raise ValueError(f'gather-GEMM: shapes {tuple(features.shape)}, '
                         f'{tuple(rulebook.shape)}, {tuple(weights.shape)}')
    if cin not in SUPPORTED_CIN or not supported_cout(cout) or not 1 <= k <= MAX_K:
        raise ValueError(f'gather-GEMM: K={k}, Cin={cin}, Cout={cout} not supported')
    if not (features.is_contiguous() and rulebook.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError('gather-GEMM: inputs must be contiguous')
    lib = cuda_build.load_library('gather_gemm', _SIG)
    out = torch.empty((v_out, cout), dtype=torch.float32, device=dev)
    bf16 = features.dtype == torch.bfloat16
    # the tensor-core path reads W as mma fragments, which the launch packs
    # into this scratch (below Cin 16 it folds several offsets into one mma
    # step, so K rounds up to 4), and reads features and rulebook 16 bytes a
    # lane
    wpack = None
    if bf16:
        if features.data_ptr() % 16 or rulebook.data_ptr() % 16:
            raise ValueError('gather-GEMM: features and rulebook must be '
                             '16-byte aligned')
        wpack = torch.empty((-(-k // 4) * 4, cin, cout), dtype=torch.bfloat16,
                            device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_gemm_launch(
            features.data_ptr(), rulebook.data_ptr(), weights.data_ptr(),
            None if wpack is None else wpack.data_ptr(), out.data_ptr(),
            v_out, k, cin, cout, int(bf16), stream)
    cuda_build.check(lib, 'gather_gemm', err)
    launches += 1
    return out
