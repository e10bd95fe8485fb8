"""Sparse-conv gather-GEMM and its backward: wrappers of the CUDA kernels
``csrc/gather_gemm.cu`` and ``csrc/gather_gemm_wgrad.cu``.

Counterpart of ``crb_active_3ddet_tpu/ops/pallas_kernels.py:60
sparse_conv_gather_gemm``: ``out[v] = Σ_k feat[rulebook[v, k]] @ W[k]`` with
−1 meaning no neighbour, accumulated in f32.  Every sparse conv layer of
``VoxelBackBone8x`` runs it through the ``SparseConvGatherGemm`` autograd
Function, whose backward computes what XLA's autodiff of the JAX package's
gather + dot computes:
  * dgrad ``dfeat[i] = Σ_k dout[inv[i, k]] @ W[k]ᵀ``: the forward kernel over
    the inverse rulebook (``ops/sparse/rulebook.py``) with per-offset
    transposed weights;
  * wgrad ``dW[k] = Σ_{v: rb[v, k] ≥ 0} feat[rb[v, k]]ᵀ dout[v]``: its own
    kernel, deterministic.
bf16: the forward and the dgrad run on tensor cores (``mma.sync``), the dgrad
with ``dout`` rounded to bf16 for them, as its plain version does (the JAX
VJP keeps it f32 and rounds each tap's product to bf16 instead).  The wgrad
runs on tensor cores too: the f32 ``dout`` enters as three bf16 terms that
sum to it, so its products are the f32 products.  Gradients come back in
their inputs' dtypes, so a bf16 ``dW`` is rounded to bf16 as the JAX VJP's
is.  f32 runs on CUDA cores in full f32 throughout; its forward and dgrad sum
each output element as one fmaf chain in ascending (offset, channel) order.
That is the order of the f32 matmul in ``subm_conv3d_gather`` (TF32 off)
where cuBLAS runs one chain an element, as at the AL path's shapes, and
there the two are bit-equal.  Both wgrad routes read the rulebook
transposed (``transpose_rulebook``, built once per rulebook by the
backbone); the f32 one gives every block an equal share of all the hits
and sums each output element as a few fmaf chains added in a fixed order.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU tensors
it runs the plain version (``ops/sparse/sparse_ops.py``).  ``launches``,
``dgrad_launches`` and ``wgrad_launches`` count the wrappers' calls that
reached the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .sparse.rulebook import transpose_rulebook
from .sparse.sparse_ops import (gather_gemm_dgrad_plain,
                                gather_gemm_wgrad_plain, subm_conv3d_gather)

launches = 0
dgrad_launches = 0
wgrad_launches = 0

_SIG = {'gather_gemm_launch': [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]}
_WSIG = {'gather_gemm_wgrad_launch': [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
         'gather_gemm_wgrad_slices': [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
SUPPORTED_CIN = (4, 8, 16, 32, 64, 128)
MAX_K = 32               # offsets a rulebook row may hold (the kernel's mask)


def supported_cout(cout):
    return cout in (16, 32) or (cout > 0 and cout % 64 == 0)


def wgrad_route(dtype):
    """Which kernel of ``csrc/gather_gemm_wgrad.cu`` a wgrad call runs:
    'mma' (tensor cores, bf16 features) or 'fma' (CUDA cores, f32)."""
    return 'mma' if dtype == torch.bfloat16 else 'fma'


def sparse_conv_gather_gemm(features, rulebook, weights):
    """features (V_in, Cin) f32 or bf16; rulebook (V_out, K) int32 (−1 =
    none, else a row of ``features``); weights (K, Cin, Cout) of the
    features' dtype.  Returns (V_out, Cout) float32."""
    global launches
    if features.device.type == 'cpu':
        return subm_conv3d_gather(features, rulebook, weights)
    out = _launch(features, rulebook, weights)
    launches += 1
    return out


def gather_gemm_dgrad(dout, rulebook, inverse, weights, v_in):
    """Input gradient of ``sparse_conv_gather_gemm``: dout (V_out, Cout) f32,
    the forward's rulebook (V_out, K) and its inverse (v_in, K) int32,
    weights (K, Cin, Cout).  Returns (v_in, Cin) float32.  On the card, the
    forward kernel over ``inverse`` with W[k]ᵀ, in the weights' dtype."""
    global dgrad_launches
    if dout.device.type == 'cpu':
        return gather_gemm_dgrad_plain(dout, rulebook, weights, v_in)
    if inverse is None or tuple(inverse.shape) != (v_in, rulebook.shape[1]):
        raise ValueError('gather-GEMM dgrad: needs the (V_in, K) inverse rulebook')
    out = _launch(dout.to(weights.dtype).contiguous(), inverse,
                  weights.transpose(1, 2).contiguous())
    dgrad_launches += 1
    return out


def gather_gemm_wgrad(features, rulebook, dout, rulebook_t=None):
    """Weight gradient of ``sparse_conv_gather_gemm``: features (V_in, Cin)
    f32 or bf16, rulebook (V_out, K) int32, dout (V_out, Cout) f32, and
    optionally the rulebook transposed, (K, V_out) (``transpose_rulebook``;
    both kernels read it, and the wrapper transposes the rulebook itself
    when it is not given).  Returns (K, Cin, Cout) float32."""
    global wgrad_launches
    if features.device.type == 'cpu':
        return gather_gemm_wgrad_plain(features, rulebook, dout)
    v_out, k = rulebook.shape
    cin, cout = features.shape[1], dout.shape[1]
    dev = features.device
    if rulebook.device != dev or dout.device != dev:
        raise ValueError('gather-GEMM wgrad: all tensors must be on one CUDA device')
    if features.dtype not in (torch.float32, torch.bfloat16) \
            or dout.dtype != torch.float32:
        raise TypeError('gather-GEMM wgrad: features f32 or bf16 and dout f32, '
                        f'got {features.dtype}, {dout.dtype}')
    if rulebook.dtype != torch.int32:
        raise TypeError(f'gather-GEMM wgrad: rulebook must be int32, got {rulebook.dtype}')
    if features.ndim != 2 or dout.shape[0] != v_out:
        raise ValueError(f'gather-GEMM wgrad: shapes {tuple(features.shape)}, '
                         f'{tuple(rulebook.shape)}, {tuple(dout.shape)}')
    if cin not in SUPPORTED_CIN or not supported_cout(cout) or not 1 <= k <= MAX_K:
        raise ValueError(f'gather-GEMM wgrad: K={k}, Cin={cin}, Cout={cout} not supported')
    if not (features.is_contiguous() and rulebook.is_contiguous()
            and dout.is_contiguous()):
        raise ValueError('gather-GEMM wgrad: inputs must be contiguous')
    if rulebook_t is None:
        rulebook_t = transpose_rulebook(rulebook)
    if rulebook_t.device != dev or rulebook_t.dtype != torch.int32 \
            or tuple(rulebook_t.shape) != (k, v_out) or not rulebook_t.is_contiguous():
        raise ValueError('gather-GEMM wgrad: the transposed rulebook must be a '
                         f'contiguous ({k}, {v_out}) int32 tensor on {dev}')
    if features.data_ptr() % 16 or dout.data_ptr() % 16 or rulebook_t.data_ptr() % 16:
        raise ValueError('gather-GEMM wgrad: features, dout and the transposed '
                         'rulebook must be 16-byte aligned')
    lib = cuda_build.load_library('gather_gemm_wgrad', _WSIG)
    bf16 = int(wgrad_route(features.dtype) == 'mma')
    cut = (ctypes.c_int * 4)()          # slices, partial floats, count ints, blocks/SM
    with torch.cuda.device(dev):
        cuda_build.check(lib, 'gather_gemm_wgrad',
                         lib.gather_gemm_wgrad_slices(v_out, k, cin, cout, bf16, cut))
        partial = torch.empty(cut[1], dtype=torch.float32, device=dev)
        counts = torch.empty(max(cut[2], 1), dtype=torch.int32, device=dev)
        dw = torch.empty((k, cin, cout), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_gemm_wgrad_launch(
            features.data_ptr(), rulebook_t.data_ptr(), dout.data_ptr(), partial.data_ptr(),
            counts.data_ptr(), dw.data_ptr(), v_out, k, cin, cout, bf16, stream)
    cuda_build.check(lib, 'gather_gemm_wgrad', err)
    wgrad_launches += 1
    return dw


class SparseConvGatherGemm(torch.autograd.Function):
    """``sparse_conv_gather_gemm`` with its backward: dgrad through the
    forward kernel over the inverse rulebook (skipped when the features need
    no gradient, as at ``conv_input``, whose input comes from a VFE without
    parameters), wgrad through its own kernel.  The wrappers are looked up at
    call time.  ``apply(features, weights, rulebook, inverse, rulebook_t)``;
    ``inverse`` and ``rulebook_t`` (the rulebook transposed, for the wgrad)
    may be None when no gradient will be asked for (eval)."""

    @staticmethod
    def forward(ctx, features, weights, rulebook, inverse, rulebook_t=None):
        ctx.save_for_backward(features, weights, rulebook, inverse, rulebook_t)
        return sparse_conv_gather_gemm(features, rulebook, weights)

    @staticmethod
    def backward(ctx, dout):
        features, weights, rulebook, inverse, rulebook_t = ctx.saved_tensors
        dout = dout.contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            dfeat = gather_gemm_dgrad(dout, rulebook, inverse, weights,
                                      features.shape[0]).to(features.dtype)
        if ctx.needs_input_grad[1]:
            dw = gather_gemm_wgrad(features, rulebook, dout,
                                   rulebook_t).to(weights.dtype)
        return dfeat, dw, None, None, None


def _launch(features, rulebook, weights):
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
    # lane; the CUDA-core path stages features and weights 16 bytes a lane
    wpack = None
    if bf16:
        if features.data_ptr() % 16 or rulebook.data_ptr() % 16:
            raise ValueError('gather-GEMM: features and rulebook must be '
                             '16-byte aligned')
        wpack = torch.empty((-(-k // 4) * 4, cin, cout), dtype=torch.bfloat16,
                            device=dev)
    elif features.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError('gather-GEMM: f32 features and weights must be '
                         '16-byte aligned')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_gemm_launch(
            features.data_ptr(), rulebook.data_ptr(), weights.data_ptr(),
            None if wpack is None else wpack.data_ptr(), out.data_ptr(),
            v_out, k, cin, cout, int(bf16), stream)
    cuda_build.check(lib, 'gather_gemm', err)
    return out
