"""PointRCNN's and PartA2's point heads (torch): port of ``PointHeadBox``,
``PointIntraPartOffsetHead``, ``assign_point_box_targets``,
``get_point_box_loss`` and ``get_point_part_loss`` from
``crb_active_3ddet_tpu/models/point_heads/point_head_box.py:28, 60, 117, 192,
225`` (reference ``pcdet/models/dense_heads/point_head_box.py``,
``point_intra_part_head.py`` and ``point_head_template.assign_stack_targets``
with part and box labels).

PointHeadBox (PointRCNN's first stage), per point of PointNet2MSG's output:
a class logit tower (``cls_layers``, one logit a class unless
CLASS_AGNOSTIC) and a box tower (``box_layers``) whose
``PointResidualCoder`` boxes, decoded at every point with the argmax class's
mean size, are the RoI head's proposals; in training the targets of
``assign_point_box_targets`` with the multi-class labels.  Its loss
(``get_point_box_loss``): the focal loss against the one-hot class, each
frame normalised by its foreground count, plus the smooth-L1 of the
code-weighted residuals over the foreground.

PartA2's, per voxel of UNetV2's output: a foreground logit tower (``cls_layers``), a
part tower (``part_reg_layers``, sigmoid: the point's place inside its
object, each axis in [0, 1]) and, when the config has ``REG_FC``
(PartA2_free), a box tower (``box_layers``) whose ``PointResidualCoder``
boxes are the RoI head's proposals.  Each tower is Linear (no bias) +
BatchNorm + ReLU blocks and a biased Linear, OpenPCDet's
``make_fc_layers``; its BatchNorms in training take Flax's statistics over
every (B, V) row, invalid voxels too, as the JAX head's.

Targets: a point's class is that of the first gt box holding it, −1 when it
is only inside a box enlarged by ``GT_EXTRA_WIDTH`` or is invalid, else 0;
its part label is its offset in that box's frame over the box's size plus
0.5, clipped to [0, 1].  Without a box tower the labels become class-
agnostic (``labels > 0``), and the box targets are still encoded, with
``PointResidualCoder(use_mean_size=False)``, as the JAX head does.  The
loss: the focal foreground loss of ``point_head_simple.get_point_loss``
(one target channel, ``labels > 0``, against every cls channel), the part
BCE over the foreground with eps 1e-6 inside both logs, and with a box
tower the weighted smooth-L1 box loss with the coder's code weights.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.points_in_boxes import points_in_boxes
from ...utils import box_utils, common, loss_utils
from ...utils.box_coder import PointResidualCoder, build_box_coder
from ..backbones_3d.pfe import pointwise_stack, run_pointwise
from .point_head_simple import get_point_loss


def assign_point_box_targets(points, points_valid, gt_boxes, extra_width, coder):
    """points (B, V, 3), points_valid (B, V), gt_boxes (B, M, 8) (all-zero
    rows are padding) → cls labels (B, V) int32, encoded box targets
    (B, V, code) (0 off the foreground) and part labels (B, V, 3)."""
    gt_valid = (torch.abs(gt_boxes).sum(-1) > 0)[:, None, :]
    in_box = points_in_boxes(points, gt_boxes[..., :7]) & gt_valid
    enlarged = box_utils.enlarge_box3d(gt_boxes[..., :7], extra_width)
    in_enl = (points_in_boxes(points, enlarged) & gt_valid).any(-1)
    first = in_box.to(torch.int8).argmax(-1)                   # the first holding box
    has_box = in_box.any(-1)
    box = common.take_rows(gt_boxes, first)                    # (B, V, 8)
    cls = torch.where(has_box, box[..., 7].to(torch.int32),
                      torch.where(in_enl, -1, 0).to(torch.int32))
    cls = torch.where(points_valid, cls, -1).to(torch.int32)
    targets = coder.encode(box[..., :7], points, gt_classes=box[..., 7].to(torch.int64))
    targets = torch.where(has_box[..., None], targets, torch.zeros_like(targets))
    b, v = points.shape[:2]
    local = common.rotate_points_along_z(
        (points - box[..., 0:3]).reshape(b * v, 1, 3), -box[..., 6].reshape(b * v))
    part = local.reshape(b, v, 3) / torch.clamp(box[..., 3:6], min=1e-6) + 0.5
    part = torch.clamp(torch.where(has_box[..., None], part, torch.zeros_like(part)), 0.0, 1.0)
    return cls, targets, part


class PointIntraPartOffsetHead(nn.Module):
    def __init__(self, model_cfg, num_class, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        n_cls = 1 if model_cfg['CLASS_AGNOSTIC'] else num_class
        self.cls_layers = pointwise_stack([input_channels, *model_cfg.get('CLS_FC', [])],
                                          nn.Linear, nn.BatchNorm1d, out_channels=n_cls)
        self.part_reg_layers = pointwise_stack(
            [input_channels, *model_cfg.get('PART_FC', [])], nn.Linear, nn.BatchNorm1d,
            out_channels=3)
        self.coder = None
        if model_cfg.get('REG_FC', None):
            target = model_cfg['TARGET_CONFIG']
            self.coder = build_box_coder(target.get('BOX_CODER', 'PointResidualCoder'),
                                         **dict(target.get('BOX_CODER_CONFIG', {})))
            self.box_layers = pointwise_stack([input_channels, *model_cfg['REG_FC']],
                                              nn.Linear, nn.BatchNorm1d,
                                              out_channels=self.coder.code_size)

    def forward(self, batch_dict):
        cfg = self.model_cfg
        feats = batch_dict['point_features']                    # (B, V, C)
        cls_preds = run_pointwise(self.cls_layers, feats)
        batch_dict['point_cls_preds'] = cls_preds
        batch_dict['point_cls_scores'] = torch.sigmoid(cls_preds.max(dim=-1).values)
        batch_dict['point_part_offset'] = torch.sigmoid(run_pointwise(self.part_reg_layers,
                                                                      feats))
        if self.coder is not None:
            box_preds = run_pointwise(self.box_layers, feats)
            batch_dict['point_box_preds_raw'] = box_preds
        coords, valid = batch_dict['point_coords'], batch_dict['point_valid']
        if self.training:
            coder = self.coder or PointResidualCoder(use_mean_size=False)
            cls, box_t, part_t = assign_point_box_targets(
                coords, valid, batch_dict['gt_boxes'],
                tuple(cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH']), coder)
            agnostic = self.coder is None or cfg['CLASS_AGNOSTIC']
            batch_dict['point_cls_labels'] = torch.where(cls > 0, 1, cls).to(torch.int32) \
                if agnostic else cls
            if self.coder is not None:
                batch_dict['point_box_labels'] = box_t
            batch_dict['point_part_labels'] = part_t
        if self.coder is not None:
            box_proposals(batch_dict, self.coder, cls_preds, box_preds, coords, valid)
        return batch_dict


def box_proposals(batch_dict, coder, cls_preds, box_preds, coords, valid):
    """Every point's decoded box (with its argmax class's mean size) and its
    logits as the proposal layer's input; an invalid point's logits are
    −1e9, so that its box never wins the NMS."""
    classes = cls_preds.argmax(-1) + 1
    batch_dict['batch_box_preds'] = coder.decode(box_preds, coords, pred_classes=classes)
    batch_dict['batch_cls_preds'] = torch.where(valid[..., None], cls_preds,
                                                torch.full_like(cls_preds, -1e9))
    batch_dict['batch_valid'] = valid
    batch_dict['cls_preds_normalized'] = False


class PointHeadBox(nn.Module):
    def __init__(self, model_cfg, num_class, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        target = model_cfg['TARGET_CONFIG']
        self.coder = build_box_coder(target.get('BOX_CODER', 'PointResidualCoder'),
                                     **dict(target.get('BOX_CODER_CONFIG', {})))
        n_cls = 1 if model_cfg['CLASS_AGNOSTIC'] else num_class
        self.cls_layers = pointwise_stack([input_channels, *model_cfg['CLS_FC']], nn.Linear,
                                          nn.BatchNorm1d, out_channels=n_cls)
        self.box_layers = pointwise_stack([input_channels, *model_cfg['REG_FC']], nn.Linear,
                                          nn.BatchNorm1d, out_channels=self.coder.code_size)

    def forward(self, batch_dict):
        feats = batch_dict['point_features']                    # (B, K, C)
        cls_preds = run_pointwise(self.cls_layers, feats)
        box_preds = run_pointwise(self.box_layers, feats)
        batch_dict['point_cls_preds'] = cls_preds
        batch_dict['point_box_preds_raw'] = box_preds
        batch_dict['point_cls_scores'] = torch.sigmoid(cls_preds.max(dim=-1).values)
        coords, valid = batch_dict['point_coords'], batch_dict['point_valid']
        if self.training:
            cls, box_t, _ = assign_point_box_targets(
                coords, valid, batch_dict['gt_boxes'],
                tuple(self.model_cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH']), self.coder)
            batch_dict['point_cls_labels'] = cls
            batch_dict['point_box_labels'] = box_t
        box_proposals(batch_dict, self.coder, cls_preds, box_preds, coords, valid)
        return batch_dict


def get_point_box_loss(batch_dict, loss_weights, reduce=True):
    """The focal loss of every point's logits against its one-hot class (0
    background, −1 ignored), each frame normalised by its foreground count,
    plus the smooth-L1 (β 1/9) of the code-weighted box residuals over the
    foreground, normalised likewise.  ``reduce=False`` keeps one loss a
    frame."""
    preds = batch_dict['point_cls_preds']                       # (B, K, C)
    labels = batch_dict['point_cls_labels'].long()
    positives = labels > 0
    pos_norm = torch.clamp(positives.sum(1, keepdim=True).to(torch.float32), min=1.0)
    cls_weights = (positives | (labels == 0)).to(torch.float32) / pos_norm
    # a class past the logits' count (a class-agnostic head) is all 0, as
    # jax.nn.one_hot makes it
    one_hot = (labels[..., None] == torch.arange(1, preds.shape[-1] + 1,
                                                 device=labels.device)).to(preds.dtype)
    cls_loss = loss_utils.sigmoid_focal_cls_loss(preds, one_hot, cls_weights).sum((-1, -2)) \
        * loss_weights.get('point_cls_weight', 1.0)
    box_preds = batch_dict['point_box_preds_raw']               # (B, K, code)
    code_w = box_preds.new_tensor(loss_weights.get('code_weights',
                                                   [1.0] * box_preds.shape[-1]))
    diff = loss_utils.smooth_l1_loss((box_preds - batch_dict['point_box_labels']) * code_w)
    box_loss = (diff.sum(-1) * positives.to(torch.float32) / pos_norm).sum(-1) \
        * loss_weights.get('point_box_weight', 1.0)
    loss = cls_loss + box_loss
    return loss.mean() if reduce else loss


def get_point_part_loss(batch_dict, loss_weights, reduce=True):
    """The focal foreground loss + the part BCE over the foreground (+ the
    box tower's smooth-L1 when it made targets).  ``reduce=False`` keeps
    one loss a frame."""
    cls_loss = get_point_loss(batch_dict, loss_weights, reduce=reduce)
    part_preds = batch_dict['point_part_offset']               # (B, V, 3), sigmoid
    part_t = batch_dict['point_part_labels']
    pos = (batch_dict['point_cls_labels'] > 0).to(torch.float32)
    eps = 1e-6
    bce = -(part_t * torch.log(part_preds + eps)
            + (1 - part_t) * torch.log(1 - part_preds + eps)).mean(-1)
    total = (bce * pos).sum(-1) / torch.clamp(pos.sum(-1), min=1.0) \
        * loss_weights.get('point_part_weight', 1.0)
    if 'point_box_labels' in batch_dict and 'point_box_preds_raw' in batch_dict:
        wn = pos / torch.clamp(pos.sum(-1, keepdim=True), min=1.0)
        box_loss = loss_utils.weighted_smooth_l1_loss(
            batch_dict['point_box_preds_raw'], batch_dict['point_box_labels'], weights=wn,
            code_weights=loss_weights.get('code_weights', None))
        total = total + box_loss.sum(dim=(-1, -2)) * loss_weights.get('point_box_weight', 1.0)
    if reduce:
        return cls_loss + total.mean()
    return cls_loss + total
