"""PointNet++ primitives (torch, fixed shapes, batched over frames): port of
``crb_active_3ddet_tpu/ops/pointnet2.py`` (reference ``pcdet/ops/pointnet2``:
``sampling_gpu.cu:25``, ``ball_query_gpu.cu``, grouping).

Ragged "stack" semantics are padded (B, N, ...) buffers with validity masks.
Farthest point sampling goes to the hand-written kernel of
``ops/cuda_fps.py``; ball query and grouping are plain tensor ops, as they are
XLA ops in the JAX package.  ``three_nn`` / ``three_interpolate`` are not
ported yet (no ported module calls them).
"""

from __future__ import annotations

import torch

from .cuda_fps import farthest_point_sample_cuda

# ball_query: at most this many (centre, source) pairs per step, which bounds
# the distance, mask, rank and slot temporaries (~25 B a pair)
_PAIR_CHUNK = 1 << 26


def farthest_point_sample(points, valid, num_samples: int):
    """(B, N, 3) padded points, (B, N) validity → (B, num_samples) int32
    indices: starts from index 0, then repeatedly picks the point farthest
    from the chosen set (ties to the lowest index).  Invalid slots are never
    picked while a valid one is left; with fewer valid points than samples
    the indices repeat."""
    return farthest_point_sample_cuda(points.to(torch.float32), valid,
                                      num_samples)


def ball_query(radius: float, nsample: int, xyz, xyz_valid, new_xyz,
               new_xyz_valid):
    """Fixed-capacity ball query, batched.

    xyz (B, N, 3) source points, new_xyz (B, M, 3) query centres.  Returns
    idx (B, M, nsample) int64 and cnt (B, M) int32: the first ``nsample``
    source points within ``radius`` of each centre, in source order; empty
    slots repeat the first hit; a row without a hit (or of an invalid
    centre) is all 0 with cnt 0.  A hit's slot is its rank among the row's
    hits (a cumsum), written with one scatter; later hits land in a spare
    column that is cut off.
    """
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = radius * radius
    src = torch.arange(n, device=xyz.device).expand(b, 1, n)
    rows = max(1, _PAIR_CHUNK // max(1, b * n))
    idx_parts, cnt_parts = [], []
    for r0 in range(0, m, rows):
        q = new_xyz[:, r0:r0 + rows]
        # (dx² + dy²) + dz², one coordinate at a time: (B, m', N) passes at
        # full width instead of a (B, m', N, 3) tensor reduced over 3
        d2 = None
        for c in range(3):
            t = q[:, :, None, c] - xyz[:, None, :, c]
            t = t * t
            d2 = t if d2 is None else d2.add_(t)
        in_ball = (d2 < r2) & xyz_valid[:, None, :] \
            & new_xyz_valid[:, r0:r0 + rows, None]
        del t, d2
        ranks = torch.cumsum(in_ball, dim=-1, dtype=torch.int32)
        slot = torch.where(in_ball & (ranks <= nsample), ranks - 1,
                           torch.full_like(ranks, nsample)).long()
        idx = torch.zeros((b, q.shape[1], nsample + 1), dtype=torch.int64,
                          device=xyz.device)
        idx.scatter_(-1, slot, src.expand(b, q.shape[1], n))
        cnt = torch.clamp(ranks[..., -1], max=nsample)
        del in_ball, ranks, slot
        idx = idx[..., :nsample]
        slot_valid = torch.arange(nsample, device=xyz.device) < cnt[..., None]
        idx_parts.append(torch.where(slot_valid, idx, idx[..., :1]))
        cnt_parts.append(cnt)
    return torch.cat(idx_parts, 1), torch.cat(cnt_parts, 1)


def grouping_operation(features, idx):
    """features (B, N, C); idx (B, M, K) → (B, M, K, C)."""
    b, m, k = idx.shape
    c = features.shape[-1]
    flat = torch.clamp(idx, min=0).reshape(b, m * k, 1).expand(b, m * k, c)
    return torch.gather(features, 1, flat).reshape(b, m, k, c)
