"""Sparse conv compute: plain gather-GEMM over rulebooks + sparse→dense scatter.

Port of ``crb_active_3ddet_tpu/ops/sparse/sparse_ops.py``.  For kernel offsets
k, ``out[o] = Σ_k in[nbr_k(o)] · W_k``; a rulebook entry −1 gathers zeros.
``subm_conv3d_gather`` is the plain version of the hand-written gather-GEMM
kernel (``ops/cuda_kernels.py``), which is what the backbone runs;
``gather_gemm_dgrad_plain`` and ``gather_gemm_wgrad_plain`` are the plain
versions of its backward.
"""

from __future__ import annotations

import torch


def gather_neighbors(features, rulebook):
    """features: (V_in, C); rulebook: (V_out, K) (−1 = none).
    Returns (V_out, K, C) with zeros where no neighbour."""
    safe = torch.clamp(rulebook, min=0).to(torch.int64)
    g = features[safe]                                   # (V_out, K, C)
    return torch.where((rulebook >= 0)[..., None], g, torch.zeros_like(g))


def _acc(*dtypes):
    """Accumulation dtype: f32 for bf16 and f32 operands, f64 for f64 (so
    that ``torch.autograd.gradcheck`` can run the plain versions)."""
    out = torch.float32
    for d in dtypes:
        out = torch.promote_types(out, d)
    return out


def subm_conv3d_gather(features, rulebook, weights):
    """One sparse conv GEMM: gather, then one matmul accumulated in f32.

    features: (V_in, Cin); rulebook: (V_out, K); weights: (K, Cin, Cout).
    Returns (V_out, Cout) float32 (float64 for f64 operands).  bf16 operands
    are widened to f32 before the product (a bf16×bf16 product is exact in
    f32), matching a dot with f32 accumulation.
    """
    v_out, k = rulebook.shape
    cin = features.shape[-1]
    cout = weights.shape[-1]
    acc = _acc(features.dtype, weights.dtype)
    g = gather_neighbors(features, rulebook).reshape(v_out, k * cin)
    return torch.matmul(g.to(acc), weights.reshape(k * cin, cout).to(acc))


def gather_gemm_dgrad_plain(dout, rulebook, weights, v_in):
    """Input gradient of ``subm_conv3d_gather``: ``dfeat[rulebook[v, k]] +=
    dout[v] @ W[k]ᵀ`` over the entries that hit, as one ``index_add_`` of the
    per-tap rows (the transpose of the gather, as XLA's autodiff forms it).
    ``dout`` is first rounded to the weights' dtype (bf16 weights: the
    operands of the kernel's tensor-core products), then the products and
    sums run in f32.

    dout: (V_out, Cout); rulebook: (V_out, K); weights: (K, Cin, Cout).
    Returns (v_in, Cin) float32 (float64 for f64 operands)."""
    v_out, k = rulebook.shape
    cin = weights.shape[1]
    acc = _acc(dout.dtype, weights.dtype)
    taps = torch.einsum('vn,kcn->vkc', dout.to(weights.dtype).to(acc),
                        weights.to(acc))
    rows = torch.where(rulebook >= 0, rulebook, v_in).to(torch.int64).reshape(-1)
    out = torch.zeros((v_in + 1, cin), dtype=acc, device=dout.device)
    out.index_add_(0, rows, taps.reshape(v_out * k, cin))
    return out[:v_in]


def gather_gemm_wgrad_plain(features, rulebook, dout):
    """Weight gradient of ``subm_conv3d_gather``: ``dW[k] = Σ_v
    feat[rulebook[v, k]]ᵀ dout[v]`` over the entries that hit, an einsum over
    the gathered rows (zeros where −1).

    features: (V_in, Cin); rulebook: (V_out, K); dout: (V_out, Cout).
    Returns (K, Cin, Cout) float32 (float64 for f64 operands)."""
    acc = _acc(features.dtype, dout.dtype)
    g = gather_neighbors(features, rulebook).to(acc)
    return torch.einsum('vkc,vn->kcn', g, dout.to(acc))


def sparse_tensor_to_dense(features, coords, valid, grid):
    """(B, V, C) + (B, V, 3) z,y,x coords → dense (B, D, H, W, C)."""
    nz, ny, nx = grid
    b, v, c = features.shape
    cells = nz * ny * nx
    coords = coords.to(torch.int64)
    flat = coords[..., 0] * (ny * nx) + coords[..., 1] * nx + coords[..., 2]
    flat = torch.where(valid, flat, torch.full_like(flat, cells))
    flat = flat + (torch.arange(b, device=flat.device) * (cells + 1))[:, None]
    canvas = torch.zeros((b * (cells + 1), c), dtype=features.dtype,
                         device=features.device)
    canvas[flat.reshape(-1)] = features.reshape(b * v, c)
    return canvas.reshape(b, cells + 1, c)[:, :cells].reshape(b, nz, ny, nx, c)
