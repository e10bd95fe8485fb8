"""Training loop (torch). Port of ``crb_active_3ddet_tpu/runtime/train.py``
(reference ``tools/train_utils/train_utils.py``): ``prepare_device_batch``
and ``host_to_device_batch`` (shared with the eval step: the host numpy batch
goes to the device and every frame is voxelized there), the train step, the
train state and ``train_one_epoch``.

The step computes what the JAX ``make_train_step`` computes: the forward in
training mode (BatchNorm on batch statistics, running statistics updated as
Flax does), ``compute_loss``, the gradients (the sparse convs' backward runs
the hand-written kernels, ``ops/cuda_kernels.py``), the global-norm clip and
the optimizer update on its schedule (``runtime/optimization.py``).  The
model and optimizer are updated in place; the step's losses stay on the
device.  Single device: the JAX step's ``mesh`` form is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    image keys pass through, and so do given ``rois`` with their
    ``roi_targets_dict`` (the two-stage heads' branch for precomputed RoI
    targets)."""
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
    for k in ('gt_boxes', 'rois', 'roi_targets_dict'):
        if k in batch:
            out[k] = batch[k]
    return out


def host_to_device_batch(batch, device='cuda'):
    """Select the array keys the device step consumes and move them to
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    keep = ('points', 'num_points', 'gt_boxes') + _CAMERA_KEYS
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keep if k in batch}


@dataclass
class TrainState:
    """The port's counterpart of the JAX ``TrainState``: parameters and
    batch statistics live in ``model``, the optax state in ``optimizer``."""
    model: torch.nn.Module
    optimizer: object
    step: int = 0


def init_train_state(model, optimizer):
    """A train state over a built model (its weights already set, e.g. by
    ``init_weights`` or a transfer) and its optimizer."""
    return TrainState(model=model, optimizer=optimizer, step=0)


def make_train_step(model, optimizer, dataset):
    """Returns ``train_step(state, device_batch, generator=None) -> (state,
    metrics)``; ``metrics`` holds the loss and its scalar terms as device
    tensors.  ``generator`` stands where the JAX step takes its dropout key:
    a ``torch.Generator`` on the model's device (a CUDA generator on the
    card), from which PV-RCNN's RoI sampler and Dropout draw; SECOND draws
    nothing and needs none."""
    voxel_cfg = dataset.voxel_cfg
    grid_size = tuple(int(g) for g in dataset.grid_size)
    pcr = tuple(float(x) for x in dataset.point_cloud_range)
    vs = tuple(float(v) for v in dataset.voxel_size)

    def train_step(state, device_batch, generator=None):
        model.train()
        batch = prepare_device_batch(device_batch, voxel_cfg, grid_size, pcr, vs)
        out = model(batch, generator)
        loss, tb = model.compute_loss(out)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in tb.items()
                   if isinstance(v, torch.Tensor) and v.ndim == 0}
        return state, metrics

    return train_step


def train_one_epoch(state, train_step, loader, device='cuda', generator=None):
    """One pass over ``loader`` (parity ``train_utils.train_one_epoch``):
    each host batch to ``device``, one step drawing from ``generator``.  The
    losses stay on the device and are read once, at the end.  Returns
    (state, mean loss)."""
    losses = [train_step(state, host_to_device_batch(batch, device),
                         generator)[1]['loss']
              for batch in loader]
    return state, float(torch.stack(losses).mean()) if losses else float('nan')
