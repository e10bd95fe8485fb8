"""Anchor head (torch): ``AnchorHeadSingle`` from
``crb_active_3ddet_tpu/models/dense_heads/anchor_head_single.py`` (reference
``anchor_head_single.py`` 1×1 conv heads, ``anchor_head_template``'s
``generate_predicted_boxes:238-285`` and losses ``:101-227``): forward, box
decoding, target assignment in training mode and the RPN losses, with the
``reduce=False`` per-sample mode that BADGE, CRB and llal read.
``AnchorHeadTemplate`` holds what ``anchor_head_multi.AnchorHeadMulti``
shares with it, as the JAX heads share ``AnchorHeadCore``.

Predictions keep the JAX layout: cls/box/dir preds (B, H, W, A·C), flattened
with the anchors in (H, W, class·S·R) order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder as box_coder_utils
from ...utils import common, loss_utils
from .anchor_generator import generate_anchors
from .target_assigner import ATSSTargetAssigner, AxisAlignedTargetAssigner

FOCAL_PRIOR = 0.01      # each cls output bias starts at -log((1 - p) / p)


class AnchorHeadTemplate(nn.Module):
    """What the anchor heads share (the JAX ``AnchorHeadCore``): the box
    coder, the flat anchors in (H, W, class·S·R) order, the target assigner
    that ``TARGET_ASSIGNER_CONFIG.NAME`` selects, the box decoding and the
    forward's tail.  A head adds its convolutions, ``forward``, and lists
    its output convolutions (``cls_convs``, whose biases start at
    ``cls_bias_init``, and ``box_convs``)."""
    cls_bias_init = -math.log((1 - FOCAL_PRIOR) / FOCAL_PRIOR)

    def __init__(self, model_cfg, num_class, class_names, grid_size, point_cloud_range,
                 predict_boxes_when_training=True):
        super().__init__()
        self.predict_boxes_when_training = predict_boxes_when_training
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
        assigners = {'AxisAlignedTargetAssigner': AxisAlignedTargetAssigner,
                     'ATSSTargetAssigner': ATSSTargetAssigner}
        name = tgt_cfg.get('NAME', 'AxisAlignedTargetAssigner')
        if name not in assigners:
            raise KeyError(f'target assigner {name} is not ported yet')
        self.target_assigner = assigners[name](
            model_cfg, class_names, self.box_coder, match_height=tgt_cfg['MATCH_HEIGHT'])

    @property
    def total_anchors(self):
        return self.anchors.shape[0]

    @staticmethod
    def _conv_nhwc(conv, x):
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _finish(self, batch_dict, cls_preds, box_preds, dir_cls_preds):
        """Record the (B, H, W, A·C)-style predictions; in training the
        targets; the decoded boxes in eval or when a RoI head reads them."""
        batch_dict['cls_preds'] = cls_preds
        batch_dict['box_preds'] = box_preds
        if dir_cls_preds is not None:
            batch_dict['dir_cls_preds'] = dir_cls_preds
        if self.training and 'gt_boxes' in batch_dict:
            batch_dict.update(self.assign_targets(batch_dict['gt_boxes']))
        if not self.training or self.predict_boxes_when_training:
            batch_cls, batch_box = self.generate_predicted_boxes(
                cls_preds, box_preds, dir_cls_preds)
            batch_dict['rpn_preds'] = cls_preds
            batch_dict['batch_cls_preds'] = batch_cls
            batch_dict['batch_box_preds'] = batch_box
            batch_dict['cls_preds_normalized'] = False
        return batch_dict

    def assign_targets(self, gt_boxes):
        """gt_boxes (B, M, 8) → box_cls_labels, box_reg_targets, reg_weights
        over the flat anchors."""
        a = sum(self.num_anchors_per_location)
        return self.target_assigner.assign_targets(
            self.anchors.reshape(-1, a, self.anchors.shape[-1]),
            self.num_anchors_per_location, gt_boxes)

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


class AnchorHeadSingle(AnchorHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, predict_boxes_when_training=True):
        super().__init__(model_cfg, num_class, class_names, grid_size, point_cloud_range,
                         predict_boxes_when_training)
        num_anchors = sum(self.num_anchors_per_location)
        self.conv_cls = nn.Conv2d(input_channels, num_anchors * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels,
                                  num_anchors * self.box_coder.code_size, 1)
        nn.init.constant_(self.conv_cls.bias, -np.log((1 - FOCAL_PRIOR) / FOCAL_PRIOR))
        nn.init.normal_(self.conv_box.weight, std=0.001)
        self.conv_dir_cls = None
        if model_cfg.get('USE_DIRECTION_CLASSIFIER', None) is not None:
            self.conv_dir_cls = nn.Conv2d(
                input_channels, num_anchors * model_cfg['NUM_DIR_BINS'], 1)

    def cls_convs(self):
        return [self.conv_cls]

    def box_convs(self):
        return [self.conv_box]

    def forward(self, batch_dict):
        x = batch_dict['spatial_features_2d']                 # (B, H, W, C)
        # cls, box, dir in this order: autograd sums x's gradient in the
        # order of its uses, and the gates' trained readings follow it
        cls_preds = self._conv_nhwc(self.conv_cls, x)         # (B, H, W, A·C)
        box_preds = self._conv_nhwc(self.conv_box, x)
        dir_cls_preds = None if self.conv_dir_cls is None \
            else self._conv_nhwc(self.conv_dir_cls, x)
        return self._finish(batch_dict, cls_preds, box_preds, dir_cls_preds)


# ---------------------------------------------------------------------------
# Losses: functions of the forward's batch_dict (anchor_head_template.py:101-236)
# ---------------------------------------------------------------------------

def add_sin_difference(boxes1, boxes2, dim: int = 6):
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(anchors, reg_targets, dir_offset=0.0, num_bins=2):
    """anchors (B, A, 7+); reg_targets (B, A, C) → one-hot (B, A, num_bins)."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = common.limit_period(rot_gt - dir_offset, 0, 2 * np.pi)
    dir_cls = torch.floor(offset_rot / (2 * np.pi / num_bins)).to(torch.int64)
    dir_cls = torch.clamp(dir_cls, 0, num_bins - 1)
    return torch.nn.functional.one_hot(dir_cls, num_bins).to(anchors.dtype)


def get_cls_layer_loss(batch_dict, head, reduce=True, new_data=None):
    """Focal classification loss; ``new_data`` (cls_preds, box_cls_labels)
    replaces the batch's, as BADGE injects them."""
    src = batch_dict if new_data is None else new_data
    cls_preds, box_cls_labels = src['cls_preds'], src['box_cls_labels']
    b = cls_preds.shape[0]
    num_class = head.num_class
    cared = box_cls_labels >= 0
    positives = box_cls_labels > 0
    negatives = box_cls_labels == 0
    lw = head.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
    pos_w = float(lw.get('pos_cls_weight', 1.0))
    neg_w = float(lw.get('neg_cls_weight', 1.0))
    cls_weights = (negatives * neg_w + positives * pos_w).to(torch.float32)
    pos_normalizer = torch.clamp(positives.sum(1, keepdim=True).to(torch.float32),
                                 min=1.0)
    cls_weights = cls_weights / pos_normalizer
    labels = box_cls_labels
    if num_class == 1:
        labels = torch.where(positives, 1, labels)
    cls_targets = (labels * cared.to(labels.dtype)).to(torch.int64)
    one_hot = torch.nn.functional.one_hot(cls_targets, num_class + 1)[..., 1:] \
        .to(cls_preds.dtype)
    loss_src = loss_utils.sigmoid_focal_cls_loss(
        cls_preds.reshape(b, -1, num_class), one_hot, cls_weights)
    w = lw['cls_weight']
    if reduce:
        return loss_src.sum() / b * w
    return loss_src.sum(dim=(-1, -2)) * w


def get_box_reg_layer_loss(batch_dict, head, reduce=True):
    """Box regression (sin-difference smooth L1) plus the direction loss."""
    box_preds = batch_dict['box_preds']
    dir_cls_preds = batch_dict.get('dir_cls_preds', None)
    box_reg_targets = batch_dict['box_reg_targets']
    box_cls_labels = batch_dict['box_cls_labels']
    b = box_preds.shape[0]
    cfg = head.model_cfg
    lw = cfg['LOSS_CONFIG']['LOSS_WEIGHTS']

    positives = box_cls_labels > 0
    reg_weights = positives.to(torch.float32)
    pos_normalizer = torch.clamp(positives.sum(1, keepdim=True).to(torch.float32),
                                 min=1.0)
    reg_weights = reg_weights / pos_normalizer

    anchors = head.anchors[None].expand(b, *head.anchors.shape)
    box_preds = box_preds.reshape(b, -1, head.box_coder.code_size)
    preds_sin, targets_sin = add_sin_difference(box_preds, box_reg_targets)
    reg_fn = (loss_utils.weighted_l1_loss
              if cfg['LOSS_CONFIG'].get('REG_LOSS_TYPE') == 'WeightedL1Loss'
              else loss_utils.weighted_smooth_l1_loss)
    loc_loss_src = reg_fn(preds_sin, targets_sin, reg_weights,
                          code_weights=lw['code_weights'])
    loc_loss = loc_loss_src.sum() / b if reduce else loc_loss_src.sum(dim=(-1, -2))
    box_loss = loc_loss * lw['loc_weight']

    if dir_cls_preds is not None:
        dir_targets = get_direction_target(anchors, box_reg_targets,
                                           dir_offset=cfg['DIR_OFFSET'],
                                           num_bins=cfg['NUM_DIR_BINS'])
        dir_logits = dir_cls_preds.reshape(b, -1, cfg['NUM_DIR_BINS'])
        weights = positives.to(dir_logits.dtype)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1.0)
        dir_loss = loss_utils.weighted_cross_entropy_loss(dir_logits, dir_targets,
                                                          weights)
        dir_loss = dir_loss.sum() / b if reduce else dir_loss.sum(dim=-1)
        box_loss = box_loss + dir_loss * lw['dir_weight']
    return box_loss


def get_loss(batch_dict, head, reduce=True):
    """rpn_loss = cls + box (+ dir), and its terms."""
    cls_loss = get_cls_layer_loss(batch_dict, head, reduce=reduce)
    box_loss = get_box_reg_layer_loss(batch_dict, head, reduce=reduce)
    rpn_loss = cls_loss + box_loss
    return rpn_loss, {'rpn_loss_cls': cls_loss, 'rpn_loss_loc': box_loss,
                      'rpn_loss': rpn_loss}


def build_dense_head(model_cfg, input_channels, num_class, class_names,
                     grid_size, point_cloud_range, predict_boxes_when_training=True,
                     voxel_size=None):
    if model_cfg['NAME'] == 'CenterHead':
        from .center_head import CenterHead
        return CenterHead(model_cfg, input_channels, num_class, class_names, grid_size,
                          point_cloud_range, voxel_size,
                          predict_boxes_when_training)
    if model_cfg['NAME'] == 'AnchorHeadSingle':
        return AnchorHeadSingle(model_cfg, input_channels, num_class,
                                class_names, grid_size, point_cloud_range,
                                predict_boxes_when_training)
    if model_cfg['NAME'] == 'AnchorHeadMulti':
        from .anchor_head_multi import AnchorHeadMulti
        return AnchorHeadMulti(model_cfg, input_channels, num_class,
                               class_names, grid_size, point_cloud_range,
                               predict_boxes_when_training)
    raise KeyError(f"dense head {model_cfg['NAME']} is not ported yet")
