"""Device-side voxelization with fixed-capacity outputs (torch).

Port of ``crb_active_3ddet_tpu/ops/voxelize.py:34 voxelize`` — itself the
on-device replacement for the reference's CPU voxelizer
(``spconv.utils.Point2VoxelCPU3d`` behind ``transform_points_to_voxels``,
``pcdet/datasets/processor/data_processor.py:115-143``).

Points are sorted by linear voxel id with a stable sort (arrival order within
a voxel), first occurrences give dense voxel slots in ascending cell order
(so truncation at ``max_voxels`` keeps the lowest cell ids and the coords come
out cell-sorted, which the windowed subm rulebook relies on), and the
(max_voxels, max_points_per_voxel, C) buffer is a row gather from the sorted
points.  Per-slot metadata is scattered by slot (the JAX function compacts
it with a second sort; the values are the same).  Outputs equal the JAX
function's element for element.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_size_from_range(point_cloud_range, voxel_size):
    pcr = np.asarray(point_cloud_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    grid = np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)
    return tuple(int(g) for g in grid)  # (nx, ny, nz)


def voxelize(points, points_valid, point_cloud_range, voxel_size,
             grid_size: tuple, max_voxels: int, max_points_per_voxel: int):
    """Voxelize one frame of padded points.

    Args:
        points: (N, C) float32 tensor, xyz in the first 3 channels.
        points_valid: (N,) bool tensor.
        point_cloud_range: (6,) [x0, y0, z0, x1, y1, z1].
        voxel_size: (3,) [vx, vy, vz].
        grid_size: (nx, ny, nz).

    Returns dict (same keys, values and order as the JAX function):
        voxels (max_voxels, max_points_per_voxel, C) float32,
        voxel_coords (max_voxels, 3) int32 in (z, y, x) order (−1 padding),
        voxel_num_points (max_voxels,) int32, voxel_valid (max_voxels,) bool,
        point_slot (N,) int32 (uncapped by max_points_per_voxel),
        num_voxels () int32.
    """
    out = voxelize_batch(points[None], points_valid[None], point_cloud_range,
                         voxel_size, grid_size, max_voxels, max_points_per_voxel)
    return {k: v[0] for k, v in out.items()}


def voxelize_batch(points, points_valid, point_cloud_range, voxel_size,
                   grid_size: tuple, max_voxels: int, max_points_per_voxel: int):
    """:func:`voxelize` for (B, N, C) points and (B, N) validity, all frames
    at once (``torch.sort`` along the last dim sorts each frame on its own);
    every output gains a leading B."""
    nx, ny, nz = grid_size
    b, n, c = points.shape
    dev = points.device
    pcr = torch.as_tensor(point_cloud_range, dtype=points.dtype, device=dev)
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=dev)

    # same f32 formula as the reference: border points land in the same voxel
    coords = torch.floor((points[..., :3] - pcr[:3]) / vs).to(torch.int64)
    in_range = ((coords >= 0).all(dim=-1) & (coords[..., 0] < nx)
                & (coords[..., 1] < ny) & (coords[..., 2] < nz))
    valid = points_valid & in_range

    num_cells = nx * ny * nz
    vid = coords[..., 2] * (ny * nx) + coords[..., 1] * nx + coords[..., 0]
    vid = torch.where(valid, vid, torch.full_like(vid, num_cells))
    vid_s, order = torch.sort(vid, dim=1, stable=True)
    valid_s = vid_s < num_cells

    first = torch.ones_like(valid_s)
    first[:, 1:] = vid_s[:, 1:] != vid_s[:, :-1]
    first &= valid_s
    slot = torch.cumsum(first.to(torch.int64), 1) - 1
    num_voxels_total = first.sum(1, keepdim=True)
    voxel_ok = valid_s & (slot < max_voxels)

    # per kept slot: first sorted position, voxel id and point count
    # (column max_voxels collects everything dropped)
    dump = torch.full_like(slot, max_voxels)
    at_first = torch.where(first & (slot < max_voxels), slot, dump)

    def by_slot(index, values, add=False):
        buf = torch.zeros((b, max_voxels + 1), dtype=torch.int64, device=dev)
        buf = buf.scatter_add(1, index, values) if add \
            else buf.scatter(1, index, values)
        return buf[:, :max_voxels]

    seg_pos = by_slot(at_first, torch.arange(n, device=dev).expand(b, n))
    vid_c = by_slot(at_first, vid_s)
    cnt_c = by_slot(torch.where(voxel_ok, slot, dump), torch.ones_like(slot),
                    add=True)

    nvox = torch.clamp(num_voxels_total, max=max_voxels)
    voxel_valid = torch.arange(max_voxels, device=dev) < nvox
    voxel_num_points = torch.where(
        voxel_valid, torch.clamp(cnt_c, max=max_points_per_voxel),
        torch.zeros_like(cnt_c))

    points_sorted = torch.gather(points, 1, order[..., None].expand(b, n, c))
    kk = torch.arange(max_points_per_voxel, device=dev)
    src = torch.clamp(seg_pos[..., None] + kk, 0, n - 1)        # (B, V, K)
    rows = torch.gather(points_sorted, 1,
                        src.reshape(b, -1, 1).expand(-1, -1, c))
    within = kk < voxel_num_points[..., None]
    voxels = torch.where(within[..., None],
                         rows.reshape(b, max_voxels, max_points_per_voxel, c),
                         torch.zeros((), dtype=points.dtype, device=dev))

    vz = vid_c // (ny * nx)
    vrem = vid_c % (ny * nx)
    voxel_coords = torch.where(
        voxel_valid[..., None], torch.stack([vz, vrem // nx, vrem % nx], dim=-1),
        torch.full((1, 1, 1), -1, dtype=torch.int64, device=dev))

    point_slot = torch.full((b, n), max_voxels, dtype=torch.int64, device=dev)
    point_slot = point_slot.scatter(1, order, torch.where(voxel_ok, slot, dump))

    return {
        'voxels': voxels,
        'voxel_coords': voxel_coords.to(torch.int32),
        'voxel_num_points': voxel_num_points.to(torch.int32),
        'voxel_valid': voxel_valid,
        'point_slot': point_slot.to(torch.int32),
        'num_voxels': nvox[:, 0].to(torch.int32),
    }
