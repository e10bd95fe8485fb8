"""Voxel feature encoders (torch). Port of ``MeanVFE``, ``PFNLayer``,
``PillarVFE``, ``DynamicMeanVFE`` and ``DynamicPillarVFE`` from
``crb_active_3ddet_tpu/models/backbones_3d/vfe.py`` (reference
``pcdet/models/backbones_3d/vfe/mean_vfe.py:14-31``, ``pillar_vfe.py:8-120``,
``dynamic_mean_vfe.py:38-76``, ``dynamic_pillar_vfe.py:49-142``).

The pillar feature net keeps the JAX package's padded semantics: voxels are
(B, V, K, C) with ``voxel_num_points``; the padded points are zeroed before
the Linear, the BatchNorm's statistics run over every (B, V, K) row (padded
points and padded pillars included, as the reference's), and the max over
K sees the padded rows, where relu(BN(0)) need not be 0.  The module names
are OpenPCDet's (``pfn_layers.{i}.linear``, ``.norm``).

The dynamic VFEs read every point through the voxelizer's uncapped
``point_slot`` (slot V: out of range, invalid or past the voxel buffer):
the means and maxes are segment reductions over a (B, V + 1, C) buffer
whose last row catches slot V and is sliced off, as in the JAX package.
``DynamicPillarVFE``'s BatchNorm statistics run over every (B, N) point
row, the invalid ones (zeroed ahead of the first Linear) included, and an
invalid point's broadcast max is that of pillar V − 1, as the JAX module's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..flax_layers import flax_batch_norm


class MeanVFE(nn.Module):
    """Per-voxel mean of point features over the (B, V, K, C) buffer."""

    def __init__(self, model_cfg, num_point_features):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = num_point_features

    def forward(self, batch_dict):
        voxels = batch_dict['voxels']                  # (B, V, K, C)
        num_points = batch_dict['voxel_num_points']    # (B, V)
        batch_dict['voxel_features'] = voxels.sum(dim=2) / torch.clamp(
            num_points[..., None].to(voxels.dtype), min=1.0)
        return batch_dict

    def get_output_feature_dim(self):
        return self.num_point_features


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (eps 1e-3, momentum 0.01) over the last axis of
    any tensor, whose training step is Flax's ``nn.BatchNorm``
    (``models/flax_layers.flax_batch_norm``).  Eval normalises with the
    running statistics in Flax's order: (x − mean)·(scale·rsqrt(var + eps))
    + bias."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x):
        if self.training:
            return flax_batch_norm(x, self, channel_dim=-1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class PFNLayer(nn.Module):
    """Linear (+ BatchNorm) + ReLU + max over the K points of a pillar: (B, V,
    K, C) → (B, V, 1, F) for the last layer, else (B, V, K, F) with F/2
    channels of its own and the broadcast max beside them."""

    def __init__(self, in_channels, out_channels, use_norm=True, last_layer=False):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, out, bias=not use_norm)
        self.norm = FlaxBatchNorm1d(out) if use_norm else None

    def forward(self, x):
        x = F.linear(x, self.linear.weight, self.linear.bias)
        if self.norm is not None:
            x = self.norm(x)
        x = torch.relu(x)
        x_max = x.amax(dim=2, keepdim=True)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    """Pillar feature net: each point's features with its offsets from the
    pillar's point mean and from the pillar's centre (and its distance with
    ``WITH_DISTANCE``), padded points zeroed, then the PFN layers."""

    def __init__(self, model_cfg, num_point_features, voxel_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.use_absolute_xyz = model_cfg.get('USE_ABSLOTE_XYZ', True)
        self.with_distance = model_cfg.get('WITH_DISTANCE', False)
        in_ch = num_point_features + 6 if self.use_absolute_xyz \
            else num_point_features + 3
        in_ch += 1 if self.with_distance else 0
        num_filters = list(model_cfg['NUM_FILTERS'])
        use_norm = model_cfg.get('USE_NORM', True)
        self.pfn_layers = nn.ModuleList()
        for i, nf in enumerate(num_filters):
            last = i == len(num_filters) - 1
            self.pfn_layers.append(PFNLayer(in_ch, nf, use_norm, last))
            in_ch = nf if last else nf // 2 * 2
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)

    def forward(self, batch_dict):
        voxels = batch_dict['voxels']                  # (B, V, K, C)
        num_points = batch_dict['voxel_num_points']    # (B, V)
        coords = batch_dict['voxel_coords']            # (B, V, 3) z, y, x
        vx, vy, vz = self.voxel_size
        x_off = vx / 2 + self.point_cloud_range[0]
        y_off = vy / 2 + self.point_cloud_range[1]
        z_off = vz / 2 + self.point_cloud_range[2]

        npts = torch.clamp(num_points[..., None, None].to(voxels.dtype), min=1.0)
        xyz = voxels[..., :3]
        f_cluster = xyz - xyz.sum(dim=2, keepdim=True) / npts
        c = coords.to(voxels.dtype)
        f_center = torch.stack([
            voxels[..., 0] - (c[..., 2:3] * vx + x_off),
            voxels[..., 1] - (c[..., 1:2] * vy + y_off),
            voxels[..., 2] - (c[..., 0:1] * vz + z_off),
        ], dim=-1)
        features = [voxels if self.use_absolute_xyz else voxels[..., 3:],
                    f_cluster, f_center]
        if self.with_distance:
            features.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        features = torch.cat(features, dim=-1)
        mask = torch.arange(voxels.shape[2], device=voxels.device) < num_points[..., None]
        features = features * mask[..., None].to(features.dtype)
        for pfn in self.pfn_layers:
            features = pfn(features)
        batch_dict['pillar_features'] = features.squeeze(2)   # (B, V, F)
        return batch_dict

    def get_output_feature_dim(self):
        return list(self.model_cfg['NUM_FILTERS'])[-1]


def _segment_sum(values, slots, num_segments):
    """(B, N, C) values and (B, N) slots in [0, V] → (B, V, C) sums; slot V
    is dropped."""
    b, _, c = values.shape
    out = values.new_zeros(b, num_segments + 1, c)
    index = slots.long()[..., None].expand(-1, -1, c)
    return out.scatter_add(1, index, values)[:, :num_segments]


def _segment_max(values, slots, num_segments):
    """(B, V, C) maxes over the (B, N, C) values of each slot; an empty
    slot reads 0, slot V is dropped."""
    b, _, c = values.shape
    out = values.new_full((b, num_segments + 1, c), float('-inf'))
    index = slots.long()[..., None].expand(-1, -1, c)
    out = out.scatter_reduce(1, index, values, 'amax')[:, :num_segments]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _rows_at(table, slots):
    """(B, N, C) rows of the (B, V, C) ``table`` at the (B, N) slots."""
    return torch.gather(table, 1, slots.long()[..., None].expand(-1, -1, table.shape[-1]))


class DynamicMeanVFE(nn.Module):
    """Per-voxel mean of the point features over every point of the voxel,
    with no cap on points a voxel."""

    def __init__(self, model_cfg, num_point_features):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = num_point_features

    def forward(self, batch_dict):
        points = batch_dict['points']                  # (B, N, C)
        slots = batch_dict['point_slot']               # (B, N)
        v = batch_dict['voxel_valid'].shape[1]
        sums = _segment_sum(points, slots, v)
        cnt = _segment_sum(torch.ones_like(points[..., :1]), slots, v)
        batch_dict['voxel_features'] = sums / torch.clamp(cnt, min=1.0)
        return batch_dict

    def get_output_feature_dim(self):
        return self.num_point_features


class PFNLayerV2(nn.Module):
    """A dynamic PFN layer's Linear (+ BatchNorm) over the point rows."""

    def __init__(self, in_channels, out_channels, use_norm):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=not use_norm)
        self.norm = FlaxBatchNorm1d(out_channels) if use_norm else None


class DynamicPillarVFE(nn.Module):
    """Pillar feature net over every point: each point's features with its
    offsets from its pillar's point mean and from its pillar's centre (z:
    from the range's middle of the one pillar height), then per layer
    Linear (+ BatchNorm) + ReLU and a max over the pillar's points, broadcast
    back beside each point's own channels but after the last layer."""

    def __init__(self, model_cfg, num_point_features, voxel_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.use_absolute_xyz = model_cfg.get('USE_ABSLOTE_XYZ', True)
        self.with_distance = model_cfg.get('WITH_DISTANCE', False)
        in_ch = num_point_features + 6 if self.use_absolute_xyz \
            else num_point_features + 3
        in_ch += 1 if self.with_distance else 0
        num_filters = list(model_cfg['NUM_FILTERS'])
        use_norm = model_cfg.get('USE_NORM', True)
        self.pfn_layers = nn.ModuleList()
        for i, nf in enumerate(num_filters):
            out = nf if i == len(num_filters) - 1 else nf // 2
            self.pfn_layers.append(PFNLayerV2(in_ch, out, use_norm))
            in_ch = 2 * out
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)

    def forward(self, batch_dict):
        points = batch_dict['points']                  # (B, N, C); xyz first
        slots = batch_dict['point_slot']               # (B, N)
        v = batch_dict['voxel_valid'].shape[1]
        valid = batch_dict['points_valid'] & (slots < v)
        xyz = points[..., :3]
        pcr, vs = self.point_cloud_range, self.voxel_size
        x_off, y_off, z_off = (vs[i] / 2 + pcr[i] for i in range(3))

        cnt = _segment_sum(torch.ones_like(xyz[..., :1]), slots, v)
        mean = _segment_sum(xyz, slots, v) / torch.clamp(cnt, min=1.0)
        safe = torch.clamp(slots, max=v - 1)
        f_cluster = xyz - _rows_at(mean, safe)

        # true divisions (by tensors: CUDA divides by a Python scalar as a
        # product with its reciprocal), as the voxelizer places the points
        vxy = xyz.new_tensor(vs[:2])
        px = torch.floor((xyz[..., 0] - pcr[0]) / vxy[0])
        py = torch.floor((xyz[..., 1] - pcr[1]) / vxy[1])
        f_center = torch.stack([xyz[..., 0] - (px * vs[0] + x_off),
                                xyz[..., 1] - (py * vs[1] + y_off),
                                xyz[..., 2] - z_off], dim=-1)
        feats = [points if self.use_absolute_xyz else points[..., 3:], f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1)
        x = torch.where(valid[..., None], x, torch.zeros_like(x))

        slots_d = torch.where(valid, slots, torch.full_like(slots, v))
        for i, pfn in enumerate(self.pfn_layers):
            x = F.linear(x, pfn.linear.weight, pfn.linear.bias)
            if pfn.norm is not None:
                x = pfn.norm(x)
            x = torch.relu(x)
            x_max = _segment_max(x, slots_d, v)        # (B, V, F)
            if i == len(self.pfn_layers) - 1:
                x = x_max
            else:
                x = torch.cat([x, _rows_at(x_max, safe)], dim=-1)
        batch_dict['pillar_features'] = torch.where(
            batch_dict['voxel_valid'][..., None], x, torch.zeros_like(x))
        return batch_dict

    def get_output_feature_dim(self):
        return list(self.model_cfg['NUM_FILTERS'])[-1]


def build_vfe(model_cfg, num_point_features, voxel_size, point_cloud_range):
    name = model_cfg['NAME']
    if name == 'MeanVFE':
        return MeanVFE(model_cfg, num_point_features)
    if name == 'DynMeanVFE':
        return DynamicMeanVFE(model_cfg, num_point_features)
    if name == 'PillarVFE':
        return PillarVFE(model_cfg, num_point_features, voxel_size, point_cloud_range)
    if name == 'DynPillarVFE':
        return DynamicPillarVFE(model_cfg, num_point_features, voxel_size,
                                point_cloud_range)
    raise KeyError(f'vfe {name} is not ported yet')
