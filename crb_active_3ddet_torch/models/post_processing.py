"""Post-processing: NMS + the per-frame outputs the AL layer reads (torch).

Port of ``post_processing`` (:110), ``post_process_frame`` (:27),
``gt_class_stats`` (:178) and ``generate_recall_record`` (:221) from
``crb_active_3ddet_tpu/models/post_processing.py`` (reference
``detector3d_template.py:186-453``).  Frames are processed as one batch (the
JAX package vmaps per frame): every output is a fixed (B, P, ...) tensor with
a validity mask.  Two-stage models hand over ``roi_labels`` (the labels,
when ``has_class_labels``: class-agnostic rcnn scores carry no class) and
``full_cls_scores`` (exported as ``pred_logits``).  SECONDNetIoU's IoU-head
score fusions (``NMS_CONFIG.SCORE_TYPE``: ``iou``, ``cls``,
``weighted_iou_cls``, ``num_pts_iou_cls``, ``score_by_class``; JAX
``post_processing.py:123-158``) replace the scores before the NMS when the
batch holds ``roi_scores``.  A config without a model-level NMS_CONFIG
(CenterPoint's pillar configs: the head's peak test already suppressed)
keeps the top ``MAX_OBJ_PER_SAMPLE`` scores at or above ``SCORE_THRESH``
(JAX ``post_processing.py:81-93``), in ``jax.lax.top_k``'s order (ties to
the lowest index).
"""

from __future__ import annotations

import torch

from ..ops import iou3d
from ..ops import nms as nms_ops
from ..ops.points_in_boxes import box_point_density, points_count_per_box, points_in_boxes
from ..utils.common import take_rows


def _masked(valid, x):
    v = valid.reshape(*valid.shape, *([1] * (x.ndim - valid.ndim)))
    return torch.where(v, x, torch.zeros_like(x))


def fused_scores(batch_dict, nms_cfg, score_type):
    """An IoU head's scores (B, R) fused with the proposals' by
    ``score_type`` (the reference's ``second_net_iou.post_processing``)."""
    cls_preds = batch_dict['batch_cls_preds']
    iou_s = cls_preds if batch_dict.get('cls_preds_normalized', False) \
        else torch.sigmoid(cls_preds)
    iou_s = iou_s.max(dim=-1).values
    cls_s = torch.sigmoid(batch_dict['roi_scores'])
    if score_type == 'iou':
        return iou_s
    if score_type == 'cls':
        return cls_s
    if score_type == 'weighted_iou_cls':
        w = nms_cfg['SCORE_WEIGHTS']
        return float(w['iou']) * iou_s + float(w['cls']) * cls_s
    if score_type == 'num_pts_iou_cls':
        cnt = points_count_per_box(batch_dict['points'][..., :3],
                                   batch_dict['batch_box_preds'][..., :7],
                                   batch_dict.get('points_valid', None))
        lo, hi = float(nms_cfg['SCORE_THRESH']['cls']), float(nms_cfg['SCORE_THRESH']['iou'])
        alpha = torch.clamp((cnt - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
        return (1 - alpha) * cls_s + alpha * iou_s
    if score_type == 'score_by_class':
        table = nms_cfg['SCORE_BY_CLASS']
        use_iou = torch.tensor([1.0 if table[c] == 'iou' else 0.0
                                for c in nms_cfg['CLASS_NAMES']], device=iou_s.device)
        sel = use_iou[torch.clamp(batch_dict['roi_labels'] - 1, min=0)]
        return sel * iou_s + (1 - sel) * cls_s
    raise NotImplementedError(score_type)


def post_processing(batch_dict, post_cfg, num_class):
    """batch_dict needs batch_cls_preds (B, A, C), batch_box_preds (B, A, 7+),
    cls_preds_normalized, optionally points (B, N, 3+) + points_valid, and
    from a RoI head has_class_labels, roi_labels (B, A), full_cls_scores
    (and, for an IoU head's SCORE_TYPE, roi_scores).  Returns a dict of
    (B, P, ...) tensors."""
    cls_preds = batch_dict['batch_cls_preds']
    box_preds = batch_dict['batch_box_preds']
    normalized = bool(batch_dict.get('cls_preds_normalized', False))
    nms_cfg = post_cfg.get('NMS_CONFIG', None)
    score_type = None if nms_cfg is None else nms_cfg.get('SCORE_TYPE', None)
    if score_type is not None and 'roi_scores' in batch_dict:
        cls_preds = fused_scores(batch_dict, nms_cfg, score_type)[..., None]
        normalized = True
    scores = cls_preds if normalized else torch.sigmoid(cls_preds)
    max_scores = scores.max(dim=-1).values
    if batch_dict.get('has_class_labels', False):
        labels = batch_dict['roi_labels']
    else:
        labels = scores.argmax(dim=-1) + 1
    logits_src = batch_dict.get('full_cls_scores', cls_preds)

    score_thresh = post_cfg.get('SCORE_THRESH', None)
    score_thresh = float(score_thresh) if score_thresh else None
    if nms_cfg is None:
        keep_idx, keep_valid, keep_scores = score_only(
            max_scores, post_cfg.get('MAX_OBJ_PER_SAMPLE', None), score_thresh)
        out = {
            'pred_boxes': _masked(keep_valid, take_rows(box_preds, keep_idx)),
            'pred_scores': _masked(keep_valid, keep_scores),
            'pred_labels': _masked(keep_valid, torch.gather(labels, 1, keep_idx)),
            'pred_logits': _masked(keep_valid, take_rows(logits_src, keep_idx)),
            'pred_valid': keep_valid,
        }
    elif bool(nms_cfg.get('MULTI_CLASSES_NMS', False)):
        mc_scores, mc_labels, mc_boxes, mc_valid, mc_idx = \
            nms_ops.multi_classes_nms(scores, box_preds, nms_cfg,
                                      score_thresh=score_thresh)
        b = cls_preds.shape[0]
        keep_valid = mc_valid.reshape(b, -1)
        keep_idx = mc_idx.reshape(b, -1)
        out = {
            'pred_boxes': _masked(keep_valid,
                                  mc_boxes.reshape(b, -1, mc_boxes.shape[-1])),
            'pred_scores': _masked(keep_valid, mc_scores.reshape(b, -1)),
            'pred_labels': _masked(keep_valid, mc_labels.reshape(b, -1)),
            'pred_logits': _masked(keep_valid, take_rows(logits_src, keep_idx)),
            'pred_valid': keep_valid,
        }
    else:
        keep_idx, keep_valid, keep_scores = nms_ops.class_agnostic_nms(
            max_scores, box_preds[..., :7], nms_cfg, score_thresh=score_thresh)
        out = {
            'pred_boxes': _masked(keep_valid, take_rows(box_preds, keep_idx)),
            'pred_scores': _masked(keep_valid, keep_scores),
            'pred_labels': _masked(keep_valid, torch.gather(labels, 1, keep_idx)),
            'pred_logits': _masked(keep_valid, take_rows(logits_src, keep_idx)),
            'pred_valid': keep_valid,
        }
    points = batch_dict.get('points', None)
    if points is not None:
        out['pred_box_unique_density'] = box_point_density(
            points[..., :3], out['pred_boxes'][..., :7],
            batch_dict.get('points_valid', None), out['pred_valid'])
    return out


def score_only(max_scores, post_max, score_thresh):
    """The selection without NMS: (B, A) scores → the indices, validity and
    scores (−1e10 where invalid) of the top ``post_max`` (default min(500,
    A)) scores at or above ``score_thresh``, each (B, min(post_max, A))."""
    a = max_scores.shape[-1]
    k = min(int(post_max) if post_max is not None else min(500, a), a)
    s = torch.where(max_scores >= (score_thresh or 0.0), max_scores,
                    torch.full_like(max_scores, float('-inf')))
    keep_scores, keep_idx = nms_ops._top_k(s, k)
    keep_valid = torch.isfinite(keep_scores)
    return keep_idx, keep_valid, torch.where(keep_valid, keep_scores,
                                             torch.full_like(keep_scores, -1e10))


def post_process_frame(cls_preds, box_preds, post_cfg, num_class,
                       normalized=False, points=None, points_valid=None):
    """Single frame: (A, num_class) logits and (A, 7+) boxes → fixed-shape
    dict of (P, ...) tensors (the batched path with B = 1)."""
    batch = {'batch_cls_preds': cls_preds[None],
             'batch_box_preds': box_preds[None],
             'cls_preds_normalized': normalized}
    if points is not None:
        batch['points'] = points[None]
        batch['points_valid'] = None if points_valid is None else points_valid[None]
    return {k: v[0] for k, v in
            post_processing(batch, post_cfg, num_class).items()}


def generate_recall_record(pred_boxes, pred_valid, gt_boxes, gt_valid,
                           thresh_list=(0.3, 0.5, 0.7)):
    """Recall counts vs 3D-IoU thresholds, batched over leading dims.

    Parity: ``detector3d_template.generate_recall_record:411-453``.  Returns
    {'gt': count, 'rcnn_<t>': count} per frame.
    """
    iou = iou3d.boxes_iou3d(gt_boxes[..., :7], pred_boxes[..., :7])
    iou = torch.where(pred_valid[..., None, :], iou, torch.zeros_like(iou))
    gt_max = torch.where(gt_valid, iou.max(dim=-1).values,
                         torch.zeros_like(gt_valid, dtype=iou.dtype))
    out = {'gt': gt_valid.sum(-1)}
    for t in thresh_list:
        out[f'rcnn_{t}'] = (gt_max > t).sum(-1)
    return out


def gt_class_stats(points, points_valid, gt_boxes, num_classes: int):
    """Per-class gt box counts and the mean / median / variance of the
    points in each class's boxes, batched: (B, N, 3+) points, (B, N)
    points_valid or None, (B, M, 8) zero-padded gt_boxes with the class id
    last → dict of (B, num_classes) tensors.

    Parity: ``detector3d_template.py:242-267``.  The median is the lower
    middle of the sorted counts, the variance the population variance, and
    an absent class reads 0 in every statistic."""
    labels = gt_boxes[..., -1].to(torch.int64)
    valid = gt_boxes.abs().sum(-1) > 0
    member = points_in_boxes(points[..., :3], gt_boxes[..., :7])     # (B, N, M)
    if points_valid is not None:
        member = member & points_valid[..., None]
    counts = member.sum(-2).to(torch.float32)                        # (B, M)
    m = gt_boxes.shape[-2]
    classes = torch.arange(1, num_classes + 1, device=gt_boxes.device)
    cls_mask = valid[:, None, :] & (labels[:, None, :] == classes[None, :, None])
    n = cls_mask.sum(-1)                                             # (B, C)
    present = n > 0
    denom = torch.clamp(n, min=1).to(torch.float32)
    cnt = counts[:, None, :].expand_as(cls_mask)
    zero = torch.zeros((), dtype=torch.float32, device=gt_boxes.device)
    mean = torch.where(present, torch.where(cls_mask, cnt, zero).sum(-1) / denom, zero)
    dev2 = torch.where(cls_mask, (cnt - mean[..., None]) ** 2, zero)
    var = torch.where(present, dev2.sum(-1) / denom, zero)
    sorted_c = torch.sort(torch.where(cls_mask, cnt, torch.full_like(cnt, float('inf'))),
                          dim=-1).values
    med_idx = torch.clamp(torch.div(n - 1, 2, rounding_mode='floor'), 0, m - 1)
    median = torch.where(present, torch.gather(sorted_c, -1, med_idx[..., None])[..., 0],
                         zero)
    return {'num_bbox': n.to(torch.int32), 'mean_points': mean,
            'median_points': median, 'variance_points': var}
