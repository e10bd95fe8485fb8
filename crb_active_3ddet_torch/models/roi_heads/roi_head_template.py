"""RoI head machinery (torch): port of
``crb_active_3ddet_tpu/models/roi_heads/roi_head_template.py`` (reference
``pcdet/models/roi_heads/roi_head_template.py`` and
``target_assigner/proposal_target_layer.py``), batched over frames: the
proposal layer, the proposal target sampling with the canonical transform,
the RCNN losses with the ``reduce=False`` per-frame mode, and the box
decoding.

Every shape is fixed: the reference's dynamic fg/bg index lists are
rank-compacted slot selections, with no host read.  The sampler draws from
a ``torch.Generator`` in place of the JAX key, and the draw is split from
the deterministic rest: ``subsample_rois`` draws each slot's RoI index
``sel``, ``targets_from_sel`` gathers the targets for a given ``sel``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import nms as nms_ops
from ...ops.iou3d import boxes_iou3d
from ...utils import common, loss_utils
from ...utils.box_coder import ResidualCoder
from ...utils.common import take_rows

_CODER = ResidualCoder()


@torch.no_grad()
def proposal_layer(batch_dict, nms_config):
    """RoIs from the dense head's decoded boxes: NMS on the raw class logits
    (no sigmoid, no score threshold).  Adds rois (B, P, 7), roi_scores,
    roi_labels (1-based), roi_valid and full_cls_scores (B, P, num_classes)
    to batch_dict."""
    box_preds = batch_dict['batch_box_preds'][..., :7]    # (B, A, 7)
    cls_preds = batch_dict['batch_cls_preds']             # (B, A, C)
    roi_scores, roi_labels = cls_preds.max(dim=-1)
    keep_idx, keep_valid, _ = nms_ops.rotated_nms_matrix(
        box_preds, roi_scores, iou_thresh=float(nms_config.NMS_THRESH),
        pre_max=int(nms_config.NMS_PRE_MAXSIZE),
        post_max=int(nms_config.NMS_POST_MAXSIZE),
        matrix_cap=int(nms_config.get('MATRIX_CAP', 2048)))
    zero = keep_valid.logical_not()
    batch_dict.update({
        'rois': take_rows(box_preds, keep_idx).masked_fill(zero[..., None], 0.0),
        'roi_scores': take_rows(roi_scores, keep_idx).masked_fill(zero, 0.0),
        'roi_labels': (take_rows(roi_labels, keep_idx) + 1).masked_fill(zero, 0),
        'full_cls_scores': take_rows(cls_preds, keep_idx).masked_fill(
            zero[..., None], 0.0),
        'roi_valid': keep_valid,
        'has_class_labels': cls_preds.shape[-1] > 1,
    })
    return batch_dict


# ---------------------------------------------------------------------------
# proposal target layer (training)
# ---------------------------------------------------------------------------

def get_max_iou_with_same_class(rois, roi_labels, gt_boxes, gt_labels, gt_valid):
    """Each RoI's largest 3D IoU over the valid gts of its own class, and
    that gt's index: rois (B, R, 7), gt_boxes (B, M, 7+) → (B, R) twice."""
    iou = boxes_iou3d(rois[..., :7], gt_boxes[..., :7])         # (B, R, M)
    same = (roi_labels[..., :, None] == gt_labels[..., None, :]) \
        & gt_valid[..., None, :]
    iou = torch.where(same, iou, torch.full_like(iou, -1.0))
    return torch.clamp(iou.max(dim=-1).values, min=0.0), iou.argmax(dim=-1)


def roi_gt_overlaps(batch_dict, sampler_cfg):
    """(max_overlaps, gt_assignment), each (B, R), of the batch's RoIs
    against its gts; all-zero gt rows are padding."""
    rois, gt_boxes = batch_dict['rois'], batch_dict['gt_boxes']
    gt_valid = torch.abs(gt_boxes).sum(-1) > 0
    if sampler_cfg.get('SAMPLE_ROI_BY_EACH_CLASS', False):
        return get_max_iou_with_same_class(
            rois, batch_dict['roi_labels'], gt_boxes,
            gt_boxes[..., -1].to(torch.int64), gt_valid)
    iou = boxes_iou3d(rois[..., :7], gt_boxes[..., :7])
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    return torch.clamp(iou.max(dim=-1).values, min=0.0), iou.argmax(dim=-1)


def _ordered_pool(mask, generator):
    """Random-order compaction over the last axis: the indices of the True
    entries first, shuffled, then the rest in index order.  Returns
    (order (B, N), count (B,))."""
    pri = torch.where(mask, torch.rand(mask.shape, generator=generator,
                                       device=mask.device),
                      torch.full(mask.shape, -1.0, device=mask.device))
    order = torch.sort(pri, dim=-1, descending=True, stable=True).indices
    return order, mask.sum(-1)


def _pick(order, n, rand_ints):
    """order (B, N) at rand_ints mod n, per frame (slot 0 when n is 0)."""
    i = torch.where(n[:, None] > 0, rand_ints % torch.clamp(n, min=1)[:, None], 0)
    return torch.gather(order, 1, i)


def subsample_rois(generator, max_overlaps, roi_valid, sampler_cfg):
    """The fixed-shape fg / hard-bg / easy-bg RoI sampling of
    ``proposal_target_layer.subsample_rois``, batched: (B, R) max overlaps
    and validity → sel (B, ROI_PER_IMAGE) int64 RoI indices and the fg
    slots (B, ROI_PER_IMAGE) bool.  Slots: [fg × nf | hard × hard_num |
    easy × the rest]; the fg slots take the shuffled fg pool in order when
    the frame has background, and draw from it with replacement when it has
    none; the bg slots draw with replacement."""
    r_total = int(sampler_cfg.ROI_PER_IMAGE)
    fg_per_image = int(np.round(float(sampler_cfg.FG_RATIO) * r_total))
    fg_thresh = min(float(sampler_cfg.REG_FG_THRESH), float(sampler_cfg.CLS_FG_THRESH))
    bg_lo = float(sampler_cfg.CLS_BG_THRESH_LO)
    hard_ratio = float(sampler_cfg.HARD_BG_RATIO)

    fg_mask = (max_overlaps >= fg_thresh) & roi_valid
    easy_mask = (max_overlaps < bg_lo) & roi_valid
    hard_mask = ((max_overlaps < float(sampler_cfg.REG_FG_THRESH))
                 & (max_overlaps >= bg_lo) & roi_valid)
    fg_order, n_fg = _ordered_pool(fg_mask, generator)
    hard_order, n_hard = _ordered_pool(hard_mask, generator)
    easy_order, n_easy = _ordered_pool(easy_mask, generator)
    n_bg = n_hard + n_easy

    nf = torch.where(n_bg > 0, torch.clamp(n_fg, max=fg_per_image),
                     torch.where(n_fg > 0, r_total, 0))
    bg_needed = r_total - nf
    hard_num = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_needed * hard_ratio).to(torch.int64), n_hard),
        torch.where(n_hard > 0, bg_needed, 0))
    b = max_overlaps.shape[0]
    slots = torch.arange(r_total, device=max_overlaps.device)[None, :]
    rand_ints = torch.randint(0, 1 << 30, (b, r_total), generator=generator,
                              device=max_overlaps.device)
    fg_seq = torch.gather(fg_order, 1, torch.minimum(
        slots, torch.clamp(n_fg, min=1)[:, None] - 1).expand(b, -1))
    fg_sel = torch.where((n_bg > 0)[:, None], fg_seq,
                         _pick(fg_order, n_fg, rand_ints))
    sel = torch.where(slots < nf[:, None], fg_sel, torch.where(
        slots < (nf + hard_num)[:, None], _pick(hard_order, n_hard, rand_ints),
        _pick(easy_order, n_easy, rand_ints)))
    return sel, (slots < nf[:, None]).expand(b, -1)


def targets_from_sel(batch_dict, sel, max_overlaps, gt_assignment, sampler_cfg):
    """The targets of the sampled slots ``sel`` (B, S), with the canonical
    transform (``roi_head_template.assign_targets``): rois, roi_labels,
    roi_scores, gt_iou_of_rois, gt_of_rois (in each RoI's frame, heading
    flipped into [−π/2, π/2]), gt_of_rois_src, reg_valid_mask and
    rcnn_cls_labels, each (B, S, ...)."""
    gt_boxes = batch_dict['gt_boxes']
    ious = torch.gather(max_overlaps, 1, sel)
    t = {'rois': take_rows(batch_dict['rois'], sel),
         'roi_labels': take_rows(batch_dict['roi_labels'], sel),
         'roi_scores': take_rows(batch_dict['roi_scores'], sel),
         'gt_iou_of_rois': ious,
         'gt_of_rois_src': take_rows(gt_boxes, torch.gather(gt_assignment, 1, sel))}
    reg_fg, fg_t = float(sampler_cfg.REG_FG_THRESH), float(sampler_cfg.CLS_FG_THRESH)
    bg_t = float(sampler_cfg.CLS_BG_THRESH)
    t['reg_valid_mask'] = (ious > reg_fg).to(torch.int32)
    if sampler_cfg.CLS_SCORE_TYPE == 'roi_iou':
        soft = (ious - bg_t) / (fg_t - bg_t)
        t['rcnn_cls_labels'] = torch.where(ious > fg_t, 1.0, torch.where(
            ious < bg_t, 0.0, soft))
    elif sampler_cfg.CLS_SCORE_TYPE == 'cls':
        labels = (ious > fg_t).to(torch.float32)
        ignore = (ious > bg_t) & (ious < fg_t)
        t['rcnn_cls_labels'] = torch.where(ignore, -1.0, labels)
    else:
        raise NotImplementedError(sampler_cfg.CLS_SCORE_TYPE)

    rois, gt = t['rois'], t['gt_of_rois_src']
    roi_ry = torch.remainder(rois[..., 6], 2 * np.pi)
    shifted = torch.cat([gt[..., 0:3] - rois[..., 0:3], gt[..., 3:6],
                         gt[..., 6:7] - roi_ry[..., None], gt[..., 7:]], dim=-1)
    gt_ct = common.rotate_points_along_z(
        shifted.reshape(-1, 1, shifted.shape[-1]), -roi_ry.reshape(-1)
    ).reshape(gt.shape)
    heading = torch.remainder(gt_ct[..., 6], 2 * np.pi)
    opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + np.pi, 2 * np.pi),
                          heading)
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
    heading = torch.clamp(heading, -np.pi / 2, np.pi / 2)
    t['gt_of_rois'] = torch.cat([gt_ct[..., :6], heading[..., None], gt_ct[..., 7:]],
                                dim=-1)
    return t


@torch.no_grad()
def assign_targets(batch_dict, sampler_cfg, generator):
    """Proposal targets of the batch's RoIs: the overlaps, the draw of
    ``ROI_PER_IMAGE`` slots a frame from ``generator`` and the gather
    (``targets_from_sel``)."""
    if generator is None:
        raise RuntimeError('the RoI sampler draws from a torch.Generator that the '
                           'caller passes; none was given')
    max_overlaps, gt_assignment = roi_gt_overlaps(batch_dict, sampler_cfg)
    sel, _ = subsample_rois(generator, max_overlaps, batch_dict['roi_valid'],
                            sampler_cfg)
    return targets_from_sel(batch_dict, sel, max_overlaps, gt_assignment, sampler_cfg)


def rois_and_targets(batch_dict, model_cfg, training, generator):
    """The RoIs a head runs on and, in training, their targets: the given
    ``rois`` (in training with their ``roi_targets_dict``), else the
    proposal layer's (``NMS_CONFIG.TRAIN`` / ``TEST``), which in training
    the sampled targets' RoIs replace.  Returns (batch_dict, targets or
    None)."""
    targets = None
    if 'rois' not in batch_dict:
        batch_dict = proposal_layer(batch_dict,
                                    model_cfg['NMS_CONFIG']['TRAIN' if training else 'TEST'])
        if training:
            targets = assign_targets(batch_dict, model_cfg['TARGET_CONFIG'], generator)
            batch_dict['rois'] = targets['rois']
            batch_dict['roi_labels'] = targets['roi_labels']
            batch_dict['roi_valid'] = torch.ones(targets['rois'].shape[:2], dtype=torch.bool,
                                                 device=targets['rois'].device)
    elif training:
        targets = batch_dict['roi_targets_dict']
    return batch_dict, targets


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _to_global(rois, box_preds):
    """(N, 7) rois and (N, 7) encodings relative to each RoI's frame →
    (N, 7) global boxes."""
    anchors0 = torch.cat([torch.zeros_like(rois[:, :3]), rois[:, 3:]], -1)
    local = _CODER.decode(box_preds, anchors0)
    rotated = common.rotate_points_along_z(local[:, None, :], rois[:, 6]).reshape(-1, 7)
    return torch.cat([rotated[:, :3] + rois[:, :3], rotated[:, 3:]], -1)


def get_box_cls_layer_loss(targets, loss_cfg, reduce=True):
    """BCE of rcnn_cls against the (soft) labels, labels < 0 ignored,
    normalised by the valid count over the batch."""
    if loss_cfg.CLS_LOSS != 'BinaryCrossEntropy':
        raise NotImplementedError(loss_cfg.CLS_LOSS)
    labels = targets['rcnn_cls_labels']
    b = labels.shape[0]
    labels_flat = labels.reshape(-1)
    loss = loss_utils.binary_cross_entropy_with_logits(
        targets['rcnn_cls'].reshape(-1), labels_flat.to(torch.float32))
    valid = (labels_flat >= 0).to(torch.float32)
    w = loss_cfg.LOSS_WEIGHTS['rcnn_cls_weight']
    norm = torch.clamp(valid.sum(), min=1.0)
    if reduce:
        return (loss * valid).sum() / norm * w
    return ((loss * valid) / norm).reshape(b, -1).sum(-1) * w


def get_box_reg_layer_loss(targets, loss_cfg, reduce=True):
    """Smooth-L1 of rcnn_reg against the RoI-frame targets over the fg
    slots, plus the corner loss of the decoded boxes against the source gts
    with CORNER_LOSS_REGULARIZATION."""
    code_size = 7
    rcnn_reg = targets['rcnn_reg']                           # (B·R, 7)
    fg_mask = targets['reg_valid_mask'].reshape(-1) > 0
    gt_ct = targets['gt_of_rois'][..., :code_size]
    gt_src = targets['gt_of_rois_src'][..., :code_size]
    roi_flat = targets['rois'].reshape(-1, code_size)
    b = gt_ct.shape[0]
    fg_sum = torch.clamp(fg_mask.sum(), min=1)

    rois_anchor = torch.cat([torch.zeros_like(roi_flat[:, :3]), roi_flat[:, 3:6],
                             torch.zeros_like(roi_flat[:, 6:7])], -1)
    reg_targets = _CODER.encode(gt_ct.reshape(-1, code_size), rois_anchor)
    lw = loss_cfg.LOSS_WEIGHTS
    loss_src = loss_utils.weighted_smooth_l1_loss(
        rcnn_reg[None], reg_targets[None], code_weights=lw['code_weights'])[0]
    loss_src = loss_src * fg_mask[:, None].to(torch.float32)
    if reduce:
        reg_loss = loss_src.sum() / fg_sum
    else:
        reg_loss = (loss_src / fg_sum).reshape(b, -1).sum(-1)
    reg_loss = reg_loss * lw['rcnn_reg_weight']

    if loss_cfg.get('CORNER_LOSS_REGULARIZATION', False):
        corner = loss_utils.get_corner_loss_lidar(
            _to_global(roi_flat, rcnn_reg.reshape(-1, code_size)),
            gt_src.reshape(-1, code_size))
        corner = torch.where(fg_mask, corner, torch.zeros_like(corner))
        if reduce:
            corner = corner.sum() / fg_sum
        else:
            corner = corner.reshape(b, -1).sum(-1) \
                / torch.clamp(fg_mask.reshape(b, -1).sum(-1), min=1)
        reg_loss = reg_loss + corner * lw['rcnn_corner_weight']
    return reg_loss


def get_rcnn_loss(targets, loss_cfg, reduce=True):
    """rcnn_loss = cls + reg, and its terms; ``reduce=False`` keeps one loss
    a frame."""
    cls = get_box_cls_layer_loss(targets, loss_cfg, reduce=reduce)
    reg = get_box_reg_layer_loss(targets, loss_cfg, reduce=reduce)
    return cls + reg, {'rcnn_loss_cls': cls, 'rcnn_loss_reg': reg}


def generate_predicted_boxes(rois, cls_preds, box_preds):
    """Decode rcnn predictions back to global boxes.  rois (B, R, 7);
    cls_preds (B·R, C); box_preds (B·R, 7) → (B, R, C), (B, R, 7)."""
    b, r = rois.shape[:2]
    boxes = _to_global(rois.reshape(-1, 7), box_preds.reshape(-1, 7))
    return cls_preds.reshape(b, r, -1), boxes.reshape(b, r, 7)


# ---- CRB stage 2's losses against hypothetical targets (JAX
# roi_head_template.py:308-316; reference crb_sampling.py:194-196) ----

def get_box_cls_layer_loss_hyp(rcnn_cls, hyp_labels):
    """Mean BCE of the logits against soft labels (the stage-1 MC-mean
    scores), both flattened."""
    return loss_utils.binary_cross_entropy_with_logits(
        rcnn_cls.reshape(-1), hyp_labels.reshape(-1)).mean()


def get_box_reg_layer_loss_hyp(rcnn_reg, hyp_targets):
    """Unreduced smooth-L1 (beta 1/9) of the flattened encoded residuals
    against hypothetical ones."""
    return loss_utils.smooth_l1_loss(rcnn_reg.reshape(-1) - hyp_targets.reshape(-1))
