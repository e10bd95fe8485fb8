"""RoI-aware pooling (torch): port of ``roiaware_pool3d`` from
``crb_active_3ddet_tpu/ops/roi_pooling.py:38`` (reference
``pcdet/ops/roiaware_pool3d/src/roiaware_pool3d_kernel.cu:111-160``),
batched over frames: each rotated RoI is cut into a G³ grid over its own
(x, y, z) axes, and the features of the points inside it are max- or
avg-pooled into its cells.

The same arithmetic as the JAX function: a point's offset from the RoI's
centre turned by cos(−yaw) / sin(−yaw), inside when each |local| ≤ half the
size, its cell ``floor((local + dims/2) / max(dims, 1e-6) · G)`` clipped to
[0, G−1].  Max pools over a ``finfo.min``-filled table and maps untouched
cells to 0 (its gradient splits evenly among tied maxima, as JAX's
``.at[].max`` does); avg divides each cell's sum by max(count, 1).  The JAX
function broadcasts every feature to every (point, RoI) pair; here the
(point, RoI) membership is built a chunk of RoIs at a time and only the
inside pairs are scattered, so no (N, R, C) tensor exists.  Max is
independent of the order of the scatter and equals the JAX result exactly;
avg may part from it by the summation order.  The scatters are
``scatter_reduce`` / ``index_add_`` (XLA scatters in the JAX package, no
Pallas kernel).
"""

from __future__ import annotations

import torch

PAIRS_PER_CHUNK = 1 << 24      # (point, RoI) pairs of one chunk's membership


def _rotate_to_local(points, rois):
    """points (B, N, 3), rois (B, R, 7) → (B, N, R, 3) in each RoI's frame."""
    shift = points[:, :, None, :] - rois[:, None, :, 0:3]
    cosa = torch.cos(-rois[..., 6])[:, None, :]
    sina = torch.sin(-rois[..., 6])[:, None, :]
    lx = shift[..., 0] * cosa - shift[..., 1] * sina
    ly = shift[..., 0] * sina + shift[..., 1] * cosa
    return torch.stack([lx, ly, shift[..., 2]], dim=-1)


def _inside_pairs(points, rois, points_valid, rois_valid, out_size, r0):
    """(frame, point, cell row) of every inside pair of one chunk of RoIs
    (those from index ``r0``); a cell row counts over all (frame, RoI,
    cell) of the batch."""
    g = out_size
    local = _rotate_to_local(points, rois)                    # (B, N, Rc, 3)
    dims = rois[:, None, :, 3:6]
    inside = (local.abs() <= dims / 2).all(-1)
    if points_valid is not None:
        inside &= points_valid[:, :, None]
    if rois_valid is not None:
        inside &= rois_valid[:, None, :]
    fb, fn, fr = inside.nonzero(as_tuple=True)
    loc = local[fb, fn, fr]
    dm = dims[fb, 0, fr]
    cell = torch.floor((loc + dm / 2) / torch.clamp(dm, min=1e-6) * g).to(torch.int64)
    cell = torch.clamp(cell, 0, g - 1)
    return fb, fn, r0 + fr, (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]


def roiaware_pool3d(points, point_features, rois, points_valid=None, rois_valid=None,
                    out_size: int = 12, pool_method: str = 'max'):
    """points (B, N, 3); point_features (B, N, C); rois (B, R, 7);
    optional validity (B, N) and (B, R).  Returns (B, R, G, G, G, C)
    pooled features, zero at empty cells, grid axes (x, y, z) of the RoI."""
    b, n, c = point_features.shape
    r = rois.shape[1]
    g3 = out_size ** 3
    chunk = max(1, PAIRS_PER_CHUNK // max(b * n, 1))
    fbs, fns, rows = [], [], []
    for r0 in range(0, r, chunk):
        sl = slice(r0, r0 + chunk)
        fb, fn, fr, flat = _inside_pairs(
            points, rois[:, sl], points_valid,
            None if rois_valid is None else rois_valid[:, sl], out_size, r0)
        fbs.append(fb)
        fns.append(fn)
        rows.append((fb * r + fr) * g3 + flat)
    fb, fn, row = torch.cat(fbs), torch.cat(fns), torch.cat(rows)
    vals = point_features[fb, fn]                              # (P, C)
    dtype, dev = point_features.dtype, point_features.device
    if pool_method == 'max':
        neg = torch.finfo(dtype).min
        out = torch.full((b * r * g3, c), neg, dtype=dtype, device=dev)
        out = out.scatter_reduce(0, row[:, None].expand(-1, c), vals, 'amax',
                                 include_self=True)
        out = torch.where(out == neg, torch.zeros_like(out), out)
    else:
        out = torch.zeros((b * r * g3, c), dtype=dtype, device=dev).index_add(0, row, vals)
        cnt = torch.zeros((b * r * g3,), dtype=dtype, device=dev).index_add(
            0, row, torch.ones_like(row, dtype=dtype))
        out = out / torch.clamp(cnt[:, None], min=1.0)
    return out.reshape(b, r, out_size, out_size, out_size, c)
