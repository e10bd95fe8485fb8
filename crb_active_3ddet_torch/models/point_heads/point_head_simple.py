"""Point head (torch): keypoint foreground segmentation for PV-RCNN, forward
pass of ``crb_active_3ddet_tpu/models/point_heads/point_head_simple.py:35``
(reference ``pcdet/models/dense_heads/point_head_simple.py``).  The target
assignment and the focal loss come with the train step.
"""

from __future__ import annotations

import torch
from torch import nn

from ..backbones_3d.pfe import pointwise_stack, run_pointwise


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, num_class, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        out = 1 if model_cfg['CLASS_AGNOSTIC'] else num_class
        self.cls_layers = pointwise_stack(
            [input_channels, *model_cfg['CLS_FC']], nn.Linear, nn.BatchNorm1d,
            out_channels=out)

    def forward(self, batch_dict):
        if self.model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False):
            feats = batch_dict['point_features_before_fusion']
        else:
            feats = batch_dict['point_features']
        preds = run_pointwise(self.cls_layers, feats)           # (B, K, C)
        batch_dict['point_cls_preds'] = preds
        batch_dict['point_cls_scores'] = torch.sigmoid(preds.max(dim=-1).values)
        return batch_dict


def build_point_head(model_cfg, num_class, pfe):
    """``pfe`` gives the width of the point features the head reads."""
    if model_cfg['NAME'] == 'PointHeadSimple':
        before = model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False)
        return PointHeadSimple(
            model_cfg, num_class,
            pfe.num_point_features_before_fusion if before
            else pfe.num_point_features)
    raise KeyError(f"point head {model_cfg['NAME']} is not ported yet")
