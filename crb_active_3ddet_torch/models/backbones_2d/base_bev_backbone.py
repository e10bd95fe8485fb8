"""Dense 2D BEV backbone (torch). Port of ``BaseBEVBackbone`` from
``crb_active_3ddet_tpu/models/backbones_2d/base_bev_backbone.py:66``
(reference ``pcdet/models/backbones_2d/base_bev_backbone.py:6-111``).

The module structure and names are OpenPCDet's (``blocks.{i}`` =
ZeroPad2d, Conv2d, BN, ReLU, [Conv2d, BN, ReLU]×n; ``deblocks.{i}`` =
ConvTranspose2d, BN, ReLU), BN eps 1e-3 with Flax's training statistics.
These are plain dense convolutions (left to cuDNN on the card, as the JAX
package leaves them to XLA).  With
``USE_BF16`` each convolution runs in bf16 and BN stays f32.  Input and output
are channels-last (B, H, W, C), like the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..flax_layers import flax_batch_norm


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-3, momentum 0.01) whose training step is
    Flax's ``nn.BatchNorm`` (``models/flax_layers.flax_batch_norm`` over
    the NCHW channel axis).  Eval is torch's, over the running statistics."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return flax_batch_norm(x, self, channel_dim=1)


def _bn(c):
    return FlaxBatchNorm2d(c)


def run_sequential(seq, x, cdt):
    """Run a conv/BN/ReLU Sequential with each convolution in dtype ``cdt``
    and everything else in f32 (x is NCHW f32)."""
    for m in seq:
        if isinstance(m, nn.ConvTranspose2d):
            x = F.conv_transpose2d(x.to(cdt), m.weight.to(cdt), None, m.stride,
                                   m.padding).float()
        elif isinstance(m, nn.Conv2d):
            x = F.conv2d(x.to(cdt), m.weight.to(cdt), None, m.stride,
                         m.padding).float()
        else:
            x = m(x)
    return x


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        layer_nums = list(model_cfg.get('LAYER_NUMS', []))
        layer_strides = list(model_cfg.get('LAYER_STRIDES', []))
        num_filters = list(model_cfg.get('NUM_FILTERS', []))
        upsample_strides = list(model_cfg.get('UPSAMPLE_STRIDES', []))
        num_upsample_filters = list(model_cfg.get('NUM_UPSAMPLE_FILTERS', []))

        if len(upsample_strides) != len(layer_nums) \
                or any(s < 1 for s in upsample_strides):
            raise ValueError('BaseBEVBackbone: the port supports one '
                             'upsampling deblock (stride >= 1) per block')
        c_in_list = [input_channels, *num_filters[:-1]]
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        for i, n in enumerate(layer_nums):
            layers = [nn.ZeroPad2d(1),
                      nn.Conv2d(c_in_list[i], num_filters[i], 3,
                                stride=layer_strides[i], padding=0, bias=False),
                      _bn(num_filters[i]), nn.ReLU()]
            for _ in range(n):
                layers += [nn.Conv2d(num_filters[i], num_filters[i], 3,
                                     padding=1, bias=False),
                           _bn(num_filters[i]), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            s = int(upsample_strides[i])
            self.deblocks.append(nn.Sequential(
                nn.ConvTranspose2d(num_filters[i], num_upsample_filters[i], s,
                                   stride=s, bias=False),
                _bn(num_upsample_filters[i]), nn.ReLU()))
        self.num_bev_features = sum(num_upsample_filters)

    def forward(self, batch_dict):
        cdt = torch.bfloat16 if self.model_cfg.get('USE_BF16', False) \
            else torch.float32
        x = batch_dict['spatial_features'].permute(0, 3, 1, 2)   # NCHW
        h_in = x.shape[2]
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = run_sequential(block, x, cdt)
            stride = int(h_in / x.shape[2])
            batch_dict[f'spatial_features_{stride}x'] = x.permute(0, 2, 3, 1)
            ups.append(run_sequential(deblock, x, cdt))
        batch_dict['spatial_features_2d'] = torch.cat(ups, dim=1).permute(
            0, 2, 3, 1)                                        # NHWC
        return batch_dict


def build_backbone_2d(model_cfg, input_channels):
    if model_cfg['NAME'] == 'BaseBEVBackbone':
        return BaseBEVBackbone(model_cfg, input_channels)
    raise KeyError(f"backbone_2d {model_cfg['NAME']} is not ported yet")
