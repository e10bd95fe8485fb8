"""Multi-head anchor RPN (torch): port of ``AnchorHeadMulti`` from
``crb_active_3ddet_tpu/models/dense_heads/anchor_head_multi.py`` (reference
``pcdet/models/dense_heads/anchor_head_multi.py``: ``SingleHead`` towers with
``SEPARATE_REG_CONFIG``'s middle convolutions, the shared conv, the heads'
outputs concatenated).

A shared 3×3 conv (no bias) + BN + ReLU when ``SHARED_CONV_NUM_FILTER`` is
set, then one tower a ``RPN_HEAD_CFGS`` entry.  A head of a_h anchors a
location predicts a_h · num_class cls channels (every class, as the JAX
head; OpenPCDet's predicts its own classes only), a_h · code_size box
channels and a_h · NUM_DIR_BINS direction channels.  With
``SEPARATE_REG_CONFIG`` the cls output and each ``REG_LIST`` entry
(``name:channels``) get their own ``NUM_MIDDLE_CONV`` 3×3 convs (no bias) +
BN + ReLU and a 3×3 output conv, and the direction conv is 3×3 too (1×1 in
OpenPCDet); without it every output conv is 1×1 on the shared features.
The heads' outputs are concatenated per location in head order, which is
the anchor order of the whole ``ANCHOR_GENERATOR_CONFIG`` when the heads
take the classes in order: anchors, target assignment, decoding and losses
are ``AnchorHeadTemplate``'s and ``anchor_head_single``'s.

Module names follow OpenPCDet's (``shared_conv.{0,1}``,
``rpn_heads.{h}.conv_cls`` / ``conv_box`` / ``conv_dir_cls``, with
``SEPARATE_REG_CONFIG`` ``conv_cls.{k}`` and ``conv_box.conv_<name>.{k}``
Sequentials); BatchNorms are ``FlaxBatchNorm2d`` (eps 1e-3, Flax's training
statistics).  Input and outputs are channels-last (B, H, W, ·).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..backbones_2d.base_bev_backbone import FlaxBatchNorm2d
from .anchor_head_single import FOCAL_PRIOR, AnchorHeadTemplate


def _conv_bn_relu(c_in, c_out):
    return [nn.Conv2d(c_in, c_out, 3, padding=1, bias=False), FlaxBatchNorm2d(c_out),
            nn.ReLU()]


class SingleHead(nn.Module):
    """One head's towers over the shared features (NCHW in and out)."""

    def __init__(self, c_in, a_h, num_class, code_size, num_dir_bins, sep_reg):
        super().__init__()
        self.a_h = a_h
        ksz = 3 if sep_reg is not None else 1

        def tower(c_out):
            if sep_reg is None:
                return nn.Conv2d(c_in, c_out, 1)
            layers, c = [], c_in
            for _ in range(int(sep_reg['NUM_MIDDLE_CONV'])):
                layers += _conv_bn_relu(c, int(sep_reg['NUM_MIDDLE_FILTER']))
                c = int(sep_reg['NUM_MIDDLE_FILTER'])
            return nn.Sequential(*layers, nn.Conv2d(c, c_out, 3, padding=1))

        self.conv_cls = tower(a_h * num_class)
        if sep_reg is None:
            self.reg_channels = [code_size]
            self.conv_box = nn.Conv2d(c_in, a_h * code_size, 1)
        else:
            regs = [str(r).split(':') for r in sep_reg['REG_LIST']]
            self.reg_channels = [int(ch) for _, ch in regs]
            self.conv_box = nn.ModuleDict({f'conv_{name}': tower(a_h * int(ch))
                                           for name, ch in regs})
        self.conv_dir_cls = None
        if num_dir_bins:
            self.conv_dir_cls = nn.Conv2d(c_in, a_h * num_dir_bins, ksz, padding=ksz // 2)
        nn.init.constant_(self.cls_out().bias, -np.log((1 - FOCAL_PRIOR) / FOCAL_PRIOR))

    def cls_out(self):
        return self.conv_cls if isinstance(self.conv_cls, nn.Conv2d) else self.conv_cls[-1]

    def box_outs(self):
        if isinstance(self.conv_box, nn.Conv2d):
            return [self.conv_box]
        return [seq[-1] for seq in self.conv_box.values()]

    def forward(self, x):
        """x (B, C, H, W) → cls (B, H, W, a_h, num_class), box (B, H, W, a_h,
        code_size), dir (B, H, W, a_h, NUM_DIR_BINS) or None."""
        def nhwc(y, ch):
            return y.permute(0, 2, 3, 1).reshape(*y.shape[:1], *y.shape[2:], self.a_h, ch)

        cls = self.conv_cls(x)
        cls = nhwc(cls, cls.shape[1] // self.a_h)
        convs = [self.conv_box] if isinstance(self.conv_box, nn.Conv2d) \
            else list(self.conv_box.values())
        box = torch.cat([nhwc(conv(x), ch) for conv, ch in zip(convs, self.reg_channels)],
                        dim=-1)
        d = None
        if self.conv_dir_cls is not None:
            d = self.conv_dir_cls(x)
            d = nhwc(d, d.shape[1] // self.a_h)
        return cls, box, d


class AnchorHeadMulti(AnchorHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, predict_boxes_when_training=True):
        super().__init__(model_cfg, num_class, class_names, grid_size, point_cloud_range,
                         predict_boxes_when_training)
        c = input_channels
        self.shared_conv = None
        if model_cfg.get('SHARED_CONV_NUM_FILTER', None):
            c = int(model_cfg['SHARED_CONV_NUM_FILTER'])
            self.shared_conv = nn.Sequential(*_conv_bn_relu(input_channels, c))
        name_to_a = dict(zip((a['class_name'] for a in model_cfg['ANCHOR_GENERATOR_CONFIG']),
                             self.num_anchors_per_location))
        use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', False)
        n_dir = int(model_cfg.get('NUM_DIR_BINS', 2)) if use_dir else 0
        sep_reg = model_cfg.get('SEPARATE_REG_CONFIG', None)
        self.rpn_heads = nn.ModuleList(
            SingleHead(c, sum(int(name_to_a[n]) for n in head['HEAD_CLS_NAME']), num_class,
                       self.box_coder.code_size, n_dir, sep_reg)
            for head in model_cfg['RPN_HEAD_CFGS'])

    def cls_convs(self):
        return [h.cls_out() for h in self.rpn_heads]

    def box_convs(self):
        return [conv for h in self.rpn_heads for conv in h.box_outs()]

    def forward(self, batch_dict):
        x = batch_dict['spatial_features_2d'].permute(0, 3, 1, 2)     # NCHW
        if self.shared_conv is not None:
            x = self.shared_conv(x)
        outs = [head(x) for head in self.rpn_heads]
        b, _, h, w = x.shape

        def cat(i):
            return torch.cat([o[i] for o in outs], dim=3).reshape(b, h, w, -1)
        dir_cls_preds = cat(2) if outs[0][2] is not None else None
        return self._finish(batch_dict, cat(0), cat(1), dir_cls_preds)
