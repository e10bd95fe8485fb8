"""Sparse→dense BEV projection (torch). Port of ``HeightCompression`` from
``crb_active_3ddet_tpu/models/backbones_2d/map_to_bev.py:48`` (reference
``height_compression.py:10-26``)."""

from __future__ import annotations

from torch import nn


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


def build_map_to_bev(model_cfg):
    if model_cfg['NAME'] == 'HeightCompression':
        return HeightCompression(model_cfg)
    raise KeyError(f"map_to_bev {model_cfg['NAME']} is not ported yet")
