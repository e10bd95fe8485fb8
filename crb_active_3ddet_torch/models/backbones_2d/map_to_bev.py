"""Sparse→dense BEV projection (torch). Port of ``PointPillarScatter`` and
``HeightCompression`` from ``crb_active_3ddet_tpu/models/backbones_2d/
map_to_bev.py:15,48`` (reference ``pointpillar_scatter.py:5-38``,
``height_compression.py:10-26``)."""

from __future__ import annotations

import torch
from torch import nn


class PointPillarScatter(nn.Module):
    """Pillar features (B, V, C) → the dense channels-last BEV canvas (B, ny,
    nx, C), one batched write: each frame's canvas holds one spare slot past
    its ny·nx cells, where the invalid pillars land, and which is sliced
    off, so that their gradient is exactly 0."""

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_bev_features = model_cfg['NUM_BEV_FEATURES']
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f'PointPillarScatter needs a grid one pillar high, got nz {nz}')

    def forward(self, batch_dict):
        feats = batch_dict['pillar_features']          # (B, V, C)
        coords = batch_dict['voxel_coords']            # (B, V, 3) z, y, x
        valid = batch_dict['voxel_valid']              # (B, V)
        b, _, c = feats.shape
        hw = self.ny * self.nx
        flat = torch.where(valid, coords[..., 1].long() * self.nx + coords[..., 2].long(), hw)
        rows = (flat + (hw + 1) * torch.arange(b, device=flat.device)[:, None]).reshape(-1)
        canvas = feats.new_zeros(b * (hw + 1), c).index_put((rows,), feats.reshape(-1, c))
        batch_dict['spatial_features'] = canvas.reshape(b, hw + 1, c)[:, :hw].reshape(
            b, self.ny, self.nx, c)
        batch_dict['spatial_features_stride'] = 1
        return batch_dict


class HeightCompression(nn.Module):
    """Dense 3D volume → BEV by folding depth into channels, channels-last:
    (B, D, H, W, C) → (B, H, W, D·C) with D outer — the JAX package's order,
    not OpenPCDet's C·D."""

    def __init__(self, model_cfg):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_bev_features = model_cfg['NUM_BEV_FEATURES']

    def forward(self, batch_dict):
        x = batch_dict['encoded_spconv_features']   # (B, D, H, W, C)
        b, d, h, w, c = x.shape
        batch_dict['spatial_features'] = x.permute(0, 2, 3, 1, 4).reshape(
            b, h, w, d * c)
        batch_dict['spatial_features_stride'] = batch_dict.get(
            'encoded_spconv_tensor_stride', 8)
        return batch_dict


def build_map_to_bev(model_cfg, grid_size):
    if model_cfg['NAME'] == 'PointPillarScatter':
        return PointPillarScatter(model_cfg, grid_size)
    if model_cfg['NAME'] == 'HeightCompression':
        return HeightCompression(model_cfg)
    raise KeyError(f"map_to_bev {model_cfg['NAME']} is not ported yet")
