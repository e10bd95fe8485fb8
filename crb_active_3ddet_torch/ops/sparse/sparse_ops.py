"""Sparse conv compute: plain gather-GEMM over rulebooks + sparse→dense scatter.

Port of ``crb_active_3ddet_tpu/ops/sparse/sparse_ops.py``.  For kernel offsets
k, ``out[o] = Σ_k in[nbr_k(o)] · W_k``; a rulebook entry −1 gathers zeros.
``subm_conv3d_gather`` is the plain version of the hand-written gather-GEMM
kernel (``ops/cuda_kernels.py``), which is what the backbone runs.
"""

from __future__ import annotations

import torch


def gather_neighbors(features, rulebook):
    """features: (V_in, C); rulebook: (V_out, K) (−1 = none).
    Returns (V_out, K, C) with zeros where no neighbour."""
    safe = torch.clamp(rulebook, min=0).to(torch.int64)
    g = features[safe]                                   # (V_out, K, C)
    return torch.where((rulebook >= 0)[..., None], g, torch.zeros_like(g))


def subm_conv3d_gather(features, rulebook, weights):
    """One sparse conv GEMM: gather, then one matmul accumulated in f32.

    features: (V_in, Cin); rulebook: (V_out, K); weights: (K, Cin, Cout).
    Returns (V_out, Cout) float32.  bf16 operands are widened to f32 before
    the product (a bf16×bf16 product is exact in f32), matching a dot with
    f32 accumulation.
    """
    v_out, k = rulebook.shape
    cin = features.shape[-1]
    cout = weights.shape[-1]
    g = gather_neighbors(features, rulebook).reshape(v_out, k * cin)
    return torch.matmul(g.to(torch.float32),
                        weights.reshape(k * cin, cout).to(torch.float32))


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
