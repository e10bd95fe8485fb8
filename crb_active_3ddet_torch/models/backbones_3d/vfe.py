"""Voxel feature encoders (torch). Port of
``crb_active_3ddet_tpu/models/backbones_3d/vfe.py`` (reference
``pcdet/models/backbones_3d/vfe/mean_vfe.py:14-31``)."""

from __future__ import annotations

import torch
from torch import nn


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


def build_vfe(model_cfg, num_point_features):
    if model_cfg['NAME'] == 'MeanVFE':
        return MeanVFE(model_cfg, num_point_features)
    raise KeyError(f"vfe {model_cfg['NAME']} is not ported yet")
