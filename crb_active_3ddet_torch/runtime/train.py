"""Training loop (torch). Port of ``crb_active_3ddet_tpu/runtime/train.py``
(reference ``tools/train_utils/train_utils.py``): ``prepare_device_batch``
and ``host_to_device_batch`` (shared with the eval step: the host numpy batch
goes to the device and every frame is voxelized there), the train step, the
train state and ``train_one_epoch``.

The step computes what the JAX ``make_train_step`` computes: the forward in
training mode (BatchNorm on batch statistics, running statistics updated as
Flax does), ``compute_loss``, the gradients (the sparse convs' backward runs
the hand-written kernels, ``ops/cuda_kernels.py``), the global-norm clip and
the optimizer update on its schedule (``runtime/optimization.py``), which
decays every parameter, those the loss does not reach too.  The
model and optimizer are updated in place; the step's losses stay on the
device.  Single device: the JAX step's ``mesh`` form is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import voxelize as vx_ops
from ..utils import common
from ..utils.common import resolve_device

_CAMERA_KEYS = ('images', 'depth_maps', 'trans_lidar_to_cam',
                'trans_cam_to_img', 'image_shape', 'gt_boxes2d')


def points_valid_mask(points, num_points):
    """(B, N) validity of the padded (B, N, C) points: the first
    ``num_points`` of each frame."""
    return torch.arange(points.shape[1], device=points.device)[None, :] \
        < num_points[:, None]


def prepare_device_batch(batch, voxel_cfg, grid_size, point_cloud_range,
                         voxel_size):
    """Device tensors → the model's input dict, with per-frame voxelization
    on the tensors' device when the dataset has a voxel processor.  Without
    one (PointRCNN over PointNet2MSG) the points, their validity and the
    batch size pass on: the JAX function drops the points there, so that
    the JAX package cannot run pointrcnn.yaml as shipped.  Camera-only
    models carry no points — image keys pass through, and so do given
    ``rois`` with their ``roi_targets_dict`` (the two-stage heads' branch
    for precomputed RoI targets)."""
    out = {}
    if 'points' in batch:
        points = batch['points']            # (B, N, C)
        points_valid = points_valid_mask(points, batch['num_points'])
        out.update(points=points, points_valid=points_valid, batch_size=points.shape[0])
    if 'points' in batch and voxel_cfg is not None:
        vox = vx_ops.voxelize_batch(points, points_valid, point_cloud_range,
                                    voxel_size, tuple(grid_size),
                                    voxel_cfg['max_voxels'],
                                    voxel_cfg['max_points_per_voxel'])
        out.update({k: vox[k] for k in ('voxels', 'voxel_coords', 'voxel_num_points',
                                        'voxel_valid', 'point_slot')})
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
    nothing and needs none.  The backward's f32 layers compute in f32, as
    the forward's (``full_f32``)."""
    geom = common.geometry(dataset)

    def train_step(state, device_batch, generator=None):
        model.train()
        batch = prepare_device_batch(device_batch, *geom)
        out = model(batch, generator)
        loss, tb = model.compute_loss(out)
        optimizer.zero_grad()
        with common.full_f32():
            loss.backward()
        with torch.no_grad():
            # a parameter the loss does not reach (llal's LossNet) takes a
            # zero gradient, as in JAX, so that AdamW's weight decay moves it
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in tb.items()
                   if isinstance(v, torch.Tensor) and v.ndim == 0}
        return state, metrics

    return train_step


def train_one_epoch(state, train_step, loader, device='cuda', generator=None,
                    logger=None, log_interval=50, tb_log=None, cur_epoch=0):
    """One pass over ``loader`` (parity ``train_utils.train_one_epoch``):
    each host batch to ``device``, one step drawing from ``generator``.  The
    losses stay on the device and are read once, at the end; only a
    ``logger`` line every ``log_interval`` steps reads one before.
    ``tb_log`` (any object with ``add_scalar(key, value, step)``) gets each
    step's loss at the end of the epoch.  Returns (state, mean loss)."""
    losses = []
    for it, batch in enumerate(loader):
        loss = train_step(state, host_to_device_batch(batch, device),
                          generator)[1]['loss']
        losses.append(loss)
        if logger is not None and it % log_interval == 0:
            logger.info('epoch %d it %d loss %.4f', cur_epoch, it, float(loss))
    if not losses:
        return state, float('nan')
    values = torch.stack(losses).cpu()
    if tb_log is not None:
        first = state.step - len(losses) + 1
        for i, v in enumerate(values.tolist()):
            tb_log.add_scalar('train/loss', v, first + i)
    return state, float(values.mean())
