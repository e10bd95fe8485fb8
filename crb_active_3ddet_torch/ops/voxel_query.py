"""Voxel query (torch, batched over frames): port of
``crb_active_3ddet_tpu/ops/voxel_query.py`` (reference
``pcdet/ops/pointnet2/pointnet2_stack/src/voxel_query_gpu.cu:10-60``).

For each query cell, the non-empty voxels of a ±``query_range`` window whose
centres lie strictly within ``radius`` of the query point, up to
``nsample`` of them.  As in the JAX package the window is probed on a
lattice of at most ``probes_per_dim`` cells an axis spanning the same
range (the reference scans every cell of the window), in z-major probe
order; hits keep that order.

The cell → voxel-row lookup is a ``torch.searchsorted`` over each frame's
sorted cell ids (the JAX package scatters a dense ``prod(grid) + 1`` table,
~47 MB a frame at KITTI's x_conv2 grid): the same rows, since the valid
cells of a frame are distinct.  A hit's slot is its rank among the row's
hits (a cumsum), written with one scatter, where the JAX package compacts
with a one-hot einsum.  The squared distance is summed as
``(dx² + dy²) + dz²`` in f32, one op at a time, as JAX sums it, so that the
strict radius test reads the same bits on the card and on the CPU.  These
are plain tensor ops, as the query is an XLA op in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _probe_offsets(query_range, probes_per_dim):
    """(P, 3) int64 z,y,x probe offsets: per axis the rounded, deduplicated
    ``linspace(-r, r, min(2r + 1, probes_per_dim))``, the first entry of
    ``query_range`` on z; z-major order."""
    offs = []
    for r in query_range:
        r = int(r)
        n = min(2 * r + 1, probes_per_dim)
        offs.append(np.unique(np.round(np.linspace(-r, r, n)).astype(np.int64)))
    oz, oy, ox = np.meshgrid(offs[0], offs[1], offs[2], indexing='ij')
    return np.stack([oz.reshape(-1), oy.reshape(-1), ox.reshape(-1)], axis=1)


def _cell_ids(cells, grid):
    """(..., 3) z,y,x int64 → (linear id, in-bounds mask)."""
    nz, ny, nx = grid
    inside = ((cells >= 0).all(-1) & (cells[..., 0] < nz)
              & (cells[..., 1] < ny) & (cells[..., 2] < nx))
    return (cells[..., 0] * ny + cells[..., 1]) * nx + cells[..., 2], inside


def voxel_query(query_cells, query_xyz, coords, valid, voxel_xyz, grid,
                query_range=(4, 4, 4), radius=0.4, nsample=16, probes_per_dim=3):
    """query_cells (B, M, 3) int z,y,x; query_xyz (B, M, 3) metric; coords
    (B, V, 3) voxel cells with ``valid`` (B, V); voxel_xyz (B, V, 3) their
    metric centres; ``grid`` (nz, ny, nx).  Returns (idx (B, M, nsample)
    int32, cnt (B, M) int32): rows of the frame's voxel array; empty slots
    repeat the first hit, and a query without a hit has idx 0 and cnt 0."""
    dev = query_cells.device
    b, m, _ = query_cells.shape
    v = coords.shape[1]
    offsets = torch.from_numpy(_probe_offsets(query_range, probes_per_dim)).to(dev)
    cells = int(np.prod(grid))

    h, inside = _cell_ids(coords.to(torch.int64), grid)
    keys, order = torch.sort(torch.where(valid & inside, h, torch.full_like(h, cells)), dim=1)

    probe = query_cells.to(torch.int64)[:, :, None, :] + offsets      # (B, M, P, 3)
    ph, p_in = _cell_ids(probe, grid)
    ph = torch.where(p_in, ph, torch.full_like(ph, cells)).reshape(b, -1)
    pos = torch.clamp(torch.searchsorted(keys, ph), max=v - 1)
    found = (torch.gather(keys, 1, pos) == ph) & (ph < cells)
    cand = torch.where(found, torch.gather(order, 1, pos), torch.full_like(pos, -1))
    cand = cand.reshape(b, m, -1)                                       # (B, M, P)

    safe = torch.clamp(cand, min=0).reshape(b, -1, 1).expand(-1, -1, 3)
    cand_xyz = torch.gather(voxel_xyz.to(torch.float32), 1, safe).reshape(b, m, -1, 3)
    d = cand_xyz - query_xyz.to(torch.float32)[:, :, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = d2 + d[..., 2] * d[..., 2]
    hit = (cand >= 0) & (d2 < torch.tensor(radius * radius, dtype=torch.float32))

    ranks = torch.cumsum(hit, dim=-1, dtype=torch.int32)
    slot = torch.where(hit & (ranks <= nsample), ranks - 1,
                       torch.full_like(ranks, nsample)).long()
    idx = torch.zeros((b, m, nsample + 1), dtype=torch.int64, device=dev)
    idx.scatter_(-1, slot, torch.clamp(cand, min=0))
    cnt = torch.clamp(ranks[..., -1], max=nsample)
    idx = idx[..., :nsample]
    slot_valid = torch.arange(nsample, device=dev) < cnt[..., None]
    idx = torch.where(slot_valid, idx, idx[..., :1])
    return idx.to(torch.int32), cnt.to(torch.int32)
