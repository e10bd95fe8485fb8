"""Point head (torch): keypoint foreground segmentation for PV-RCNN, port of
``crb_active_3ddet_tpu/models/point_heads/point_head_simple.py`` (reference
``pcdet/models/dense_heads/point_head_simple.py`` and
``point_head_template.assign_stack_targets``): the forward pass, the
class-agnostic target assignment in training mode and the focal loss, with
the ``reduce=False`` per-frame mode.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.points_in_boxes import points_in_boxes
from ...utils import box_utils, loss_utils
from ..backbones_3d.pfe import pointwise_stack, run_pointwise


def assign_point_targets(points, points_valid, gt_boxes, extra_width):
    """points (B, K, 3), points_valid (B, K), gt_boxes (B, M, 8) → (B, K)
    int32 labels: 1 inside a valid gt box, −1 (ignored) only inside one
    enlarged by ``extra_width``, 0 elsewhere, −1 for an invalid point.
    All-zero gt rows are padding."""
    gt_valid = (torch.abs(gt_boxes).sum(-1) > 0)[:, None, :]
    in_box = (points_in_boxes(points, gt_boxes[..., :7]) & gt_valid).any(-1)
    enlarged = box_utils.enlarge_box3d(gt_boxes[..., :7], extra_width)
    in_enlarged = (points_in_boxes(points, enlarged) & gt_valid).any(-1)
    labels = torch.where(in_box, 1, torch.where(in_enlarged, -1, 0))
    return torch.where(points_valid, labels, -1).to(torch.int32)


def get_point_loss(batch_dict, loss_weights, reduce=True):
    """Focal segmentation loss over the keypoints, each frame normalised by
    its foreground count (reference ``point_head_template.get_cls_layer_loss``).
    ``reduce=False`` keeps one loss a frame."""
    preds = batch_dict['point_cls_preds']            # (B, K, 1)
    labels = batch_dict['point_cls_labels']          # (B, K)
    positives = labels > 0
    negatives = labels == 0
    cls_weights = positives * 1.0 + negatives * 1.0
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32),
                           min=1.0)
    cls_weights = cls_weights / pos_norm
    one_hot = positives[..., None].to(preds.dtype)
    loss = loss_utils.sigmoid_focal_cls_loss(preds, one_hot, cls_weights)
    w = loss_weights.get('point_cls_weight', 1.0)
    if reduce:
        return loss.sum() / preds.shape[0] * w
    return loss.sum(dim=(-1, -2)) * w


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
        if self.training:
            batch_dict['point_cls_labels'] = assign_point_targets(
                batch_dict['point_coords'], batch_dict['point_coords_valid'],
                batch_dict['gt_boxes'],
                tuple(self.model_cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH']))
        return batch_dict


def build_point_head(model_cfg, num_class, pfe):
    """``pfe`` gives the width of the point features the head reads: PV-RCNN's
    keypoint branch, UNetV2 (PartA2's part head) or PointNet2MSG
    (PointRCNN's box head)."""
    if model_cfg['NAME'] == 'PointIntraPartOffsetHead':
        from .point_head_box import PointIntraPartOffsetHead
        return PointIntraPartOffsetHead(model_cfg, num_class, pfe.num_point_features)
    if model_cfg['NAME'] == 'PointHeadBox':
        from .point_head_box import PointHeadBox
        return PointHeadBox(model_cfg, num_class, pfe.num_point_features)
    if model_cfg['NAME'] == 'PointHeadSimple':
        before = model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False)
        return PointHeadSimple(
            model_cfg, num_class,
            pfe.num_point_features_before_fusion if before
            else pfe.num_point_features)
    raise KeyError(f"point head {model_cfg['NAME']} is not ported yet")
