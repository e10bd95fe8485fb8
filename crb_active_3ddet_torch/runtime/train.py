"""Batch preparation shared by the train and eval steps (torch).

Port of ``prepare_device_batch`` and ``host_to_device_batch`` from
``crb_active_3ddet_tpu/runtime/train.py:39-78``: the host numpy batch goes to
the device and every frame is voxelized there (``ops/voxelize.py``).  The
train step itself comes with the next slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import voxelize as vx_ops
from ..utils.common import resolve_device

_CAMERA_KEYS = ('images', 'depth_maps', 'trans_lidar_to_cam',
                'trans_cam_to_img', 'image_shape', 'gt_boxes2d')


def prepare_device_batch(batch, voxel_cfg, grid_size, point_cloud_range,
                         voxel_size):
    """Device tensors → the model's input dict, with per-frame voxelization
    on the tensors' device.  Camera-only models carry no points/voxel_cfg —
    image keys pass through."""
    out = {}
    if 'points' in batch and voxel_cfg is not None:
        points = batch['points']            # (B, N, C)
        num_points = batch['num_points']    # (B,)
        n = points.shape[1]
        points_valid = torch.arange(n, device=points.device)[None, :] \
            < num_points[:, None]
        vox = vx_ops.voxelize_batch(points, points_valid, point_cloud_range,
                                    voxel_size, tuple(grid_size),
                                    voxel_cfg['max_voxels'],
                                    voxel_cfg['max_points_per_voxel'])
        out.update({
            'points': points,
            'points_valid': points_valid,
            'voxels': vox['voxels'],
            'voxel_coords': vox['voxel_coords'],
            'voxel_num_points': vox['voxel_num_points'],
            'voxel_valid': vox['voxel_valid'],
            'point_slot': vox['point_slot'],
            'batch_size': points.shape[0],
        })
    for k in _CAMERA_KEYS:
        if k in batch:
            out[k] = batch[k]
            out.setdefault('batch_size', batch[k].shape[0])
    if 'gt_boxes' in batch:
        out['gt_boxes'] = batch['gt_boxes']
    return out


def host_to_device_batch(batch, device='cuda'):
    """Select the array keys the device step consumes and move them to
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    keep = ('points', 'num_points', 'gt_boxes') + _CAMERA_KEYS
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keep if k in batch}
