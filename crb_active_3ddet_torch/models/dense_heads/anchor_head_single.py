"""Anchor head (torch): forward pass and box decoding of ``AnchorHeadSingle``
from ``crb_active_3ddet_tpu/models/dense_heads/anchor_head_single.py``
(reference ``anchor_head_single.py`` 1×1 conv heads and
``anchor_head_template.generate_predicted_boxes:238-285``).  The target
assigner and the losses come with the train step.

Predictions keep the JAX layout: cls/box/dir preds (B, H, W, A·C), flattened
with the anchors in (H, W, class·S·R) order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils import box_coder as box_coder_utils
from ...utils import common
from .anchor_generator import generate_anchors


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = list(class_names)
        tgt_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        self.box_coder = getattr(box_coder_utils, tgt_cfg['BOX_CODER'])(
            num_dir_bins=tgt_cfg.get('NUM_DIR_BINS', 6),
            **tgt_cfg.get('BOX_CODER_CONFIG', {}))
        anchors_list, self.num_anchors_per_location = generate_anchors(
            model_cfg['ANCHOR_GENERATOR_CONFIG'], grid_size=np.asarray(grid_size),
            point_cloud_range=list(point_cloud_range),
            anchor_ndim=self.box_coder.code_size)
        cat = np.concatenate(anchors_list, axis=-3)
        self.register_buffer('anchors', torch.from_numpy(
            cat.reshape(-1, cat.shape[-1]).astype(np.float32)), persistent=False)
        num_anchors = sum(self.num_anchors_per_location)

        pi = 0.01
        self.conv_cls = nn.Conv2d(input_channels, num_anchors * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels,
                                  num_anchors * self.box_coder.code_size, 1)
        nn.init.constant_(self.conv_cls.bias, -np.log((1 - pi) / pi))
        nn.init.normal_(self.conv_box.weight, std=0.001)
        self.conv_dir_cls = None
        if model_cfg.get('USE_DIRECTION_CLASSIFIER', None) is not None:
            self.conv_dir_cls = nn.Conv2d(
                input_channels, num_anchors * model_cfg['NUM_DIR_BINS'], 1)

    @property
    def total_anchors(self):
        return self.anchors.shape[0]

    @staticmethod
    def _conv_nhwc(conv, x):
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, batch_dict):
        x = batch_dict['spatial_features_2d']                 # (B, H, W, C)
        cls_preds = self._conv_nhwc(self.conv_cls, x)         # (B, H, W, A·C)
        box_preds = self._conv_nhwc(self.conv_box, x)
        batch_dict['cls_preds'] = cls_preds
        batch_dict['box_preds'] = box_preds
        dir_cls_preds = None
        if self.conv_dir_cls is not None:
            dir_cls_preds = self._conv_nhwc(self.conv_dir_cls, x)
            batch_dict['dir_cls_preds'] = dir_cls_preds
        batch_cls, batch_box = self.generate_predicted_boxes(
            cls_preds, box_preds, dir_cls_preds)
        batch_dict['rpn_preds'] = cls_preds
        batch_dict['batch_cls_preds'] = batch_cls
        batch_dict['batch_box_preds'] = batch_box
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

    def generate_predicted_boxes(self, cls_preds, box_preds, dir_cls_preds=None):
        """(B, H, W, C·A)-style preds → (B, A_total, num_class) and
        (B, A_total, 7+)."""
        b = cls_preds.shape[0]
        batch_cls = cls_preds.reshape(b, self.total_anchors, -1)
        batch_box = self.box_coder.decode(
            box_preds.reshape(b, self.total_anchors, -1), self.anchors[None])
        if dir_cls_preds is not None:
            cfg = self.model_cfg
            dir_offset = cfg['DIR_OFFSET']
            num_bins = cfg['NUM_DIR_BINS']
            dir_labels = dir_cls_preds.reshape(
                b, self.total_anchors, -1).argmax(dim=-1)
            period = 2 * np.pi / num_bins
            dir_rot = common.limit_period(batch_box[..., 6] - dir_offset,
                                          cfg['DIR_LIMIT_OFFSET'], period)
            heading = dir_rot + dir_offset + period * dir_labels.to(batch_box.dtype)
            batch_box = torch.cat([batch_box[..., :6], heading[..., None],
                                   batch_box[..., 7:]], dim=-1)
        return batch_cls, batch_box


def build_dense_head(model_cfg, input_channels, num_class, class_names,
                     grid_size, point_cloud_range):
    if model_cfg['NAME'] == 'AnchorHeadSingle':
        return AnchorHeadSingle(model_cfg, input_channels, num_class,
                                class_names, grid_size, point_cloud_range)
    raise KeyError(f"dense head {model_cfg['NAME']} is not ported yet")
