"""RoI pooling (torch): ports of ``roiaware_pool3d`` and ``roipoint_pool3d``
from ``crb_active_3ddet_tpu/ops/roi_pooling.py:38, 80`` (reference
``pcdet/ops/roiaware_pool3d/src/roiaware_pool3d_kernel.cu:111-160`` and
``pcdet/ops/roipoint_pool3d/src/roipoint_pool3d_kernel.cu:38-103``), batched
over frames.

RoI-aware pooling (PartA2): each rotated RoI is cut into a G³ grid over its
own (x, y, z) axes, and the features of the points inside it are max- or
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

RoI point pooling (PointRCNN): the first S member points of each RoI in
point order, with their features; an RoI with fewer members repeats them
(slot k holds member k mod count), one without any is all 0 and flagged
empty.  The JAX function scatters every (RoI, point) pair into the slots;
here the first S members' indices are found a chunk of RoIs at a time (a
cumsum of the membership) and the rows are gathered once.
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


def _inside(points, rois, points_valid, rois_valid):
    """(local (B, N, R, 3), membership (B, N, R)): inside when each |local|
    ≤ half the size."""
    local = _rotate_to_local(points, rois)
    inside = (local.abs() <= rois[:, None, :, 3:6] / 2).all(-1)
    if points_valid is not None:
        inside &= points_valid[:, :, None]
    if rois_valid is not None:
        inside &= rois_valid[:, None, :]
    return local, inside


def _inside_pairs(points, rois, points_valid, rois_valid, out_size, r0):
    """(frame, point, cell row) of every inside pair of one chunk of RoIs
    (those from index ``r0``); a cell row counts over all (frame, RoI,
    cell) of the batch."""
    g = out_size
    local, inside = _inside(points, rois, points_valid, rois_valid)   # (B, N, Rc, ·)
    dims = rois[:, None, :, 3:6]
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


def roipoint_pool3d(points, point_features, rois, points_valid=None, rois_valid=None,
                    num_sampled_points: int = 512, extra_width=(0.0, 0.0, 0.0)):
    """points (B, N, 3); point_features (B, N, C); rois (B, R, 7), each
    enlarged by ``extra_width`` (added to its sizes); optional validity
    (B, N) and (B, R).  Returns pooled (B, R, S, 3 + C) [xyz | features]
    and empty (B, R) bool."""
    b, n, _ = points.shape
    r = rois.shape[1]
    s = num_sampled_points
    rois = torch.cat([rois[..., :3], rois[..., 3:6] + rois.new_tensor(extra_width),
                      rois[..., 6:]], dim=-1)
    chunk = max(1, PAIRS_PER_CHUNK // max(b * n, 1))
    src = torch.arange(n, device=points.device).expand(b, 1, n)
    slots, counts = [], []
    for r0 in range(0, r, chunk):
        sl = slice(r0, r0 + chunk)
        inside = _inside(points, rois[:, sl], points_valid,
                         None if rois_valid is None else rois_valid[:, sl])[1].transpose(1, 2)
        rank = torch.cumsum(inside, dim=-1, dtype=torch.int32)     # (B, Rc, N)
        slot = torch.where(inside & (rank <= s), rank - 1, torch.full_like(rank, s)).long()
        first = torch.zeros((b, inside.shape[1], s + 1), dtype=torch.int64,
                            device=points.device)
        first.scatter_(-1, slot, src.expand_as(slot))
        slots.append(first[..., :s])
        counts.append(rank[..., -1])
        del inside, rank, slot
    first, count = torch.cat(slots, 1), torch.cat(counts, 1)
    wrap = torch.arange(s, device=points.device) % torch.clamp(count, min=1)[..., None]
    idx = torch.gather(first, -1, wrap)                                 # (B, R, S)
    table = torch.cat([points, point_features.to(points.dtype)], dim=-1)
    c = table.shape[-1]
    pooled = torch.gather(table, 1, idx.reshape(b, r * s, 1).expand(b, r * s, c))
    empty = count == 0
    pooled = pooled.reshape(b, r, s, c).masked_fill(empty[..., None, None], 0.0)
    return pooled, empty
