"""Exact rotated NMS as a fixpoint over the overlap matrix (torch).

Port of ``crb_active_3ddet_tpu/ops/nms.py`` (``rotated_nms_matrix`` :174,
``_suppress_fixpoint_packed`` :132, ``class_agnostic_nms``,
``multi_classes_nms``), the replacement for the reference CUDA bitmask NMS
(``pcdet/ops/iou3d_nms/src/iou3d_nms_kernel.cu:267``; Python surface
``model_nms_utils.class_agnostic_nms`` / ``multi_classes_nms``).

Greedy NMS keeps exactly the boxes solving
    keep_i = NOT OR_{j<i, iou(i,j)>t} keep_j          (score-descending i),
reached by iterating from all-kept.  The (K, K) overlap matrix comes from
``ops/iou3d.boxes_overlap_bev`` (the hand-written kernel of
``ops/cuda_overlap.py`` on a card), one launch for the whole batch.
Reference behaviours kept on purpose: boxes ranked below
``matrix_cap`` never enter the kept set, and the fixpoint stops after
``rounds`` rounds.  ``jax.lax.top_k`` becomes a stable descending sort: ties
go to the lowest index, as in XLA.
"""

from __future__ import annotations

import torch

from . import iou3d

_NEG_INF = -1e10


def _top_k(x, k):
    """Descending top-k along the last dim; ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_fixpoint_packed(o_lower, rounds: int):
    """Greedy-NMS fixpoint on a bit-packed suppression matrix.

    o_lower: (..., K, K) bool, [i, j] True iff j < i, both alive and
    iou(i, j) > thresh.  Returns keep (..., K) bool.  Columns are packed
    32 to a word; the loop stops when no batch entry changes or after
    ``rounds`` rounds (a converged entry does not change in further rounds,
    so stopping on the whole batch equals stopping per entry).
    """
    *bs, k, _ = o_lower.shape
    w = -(-k // 32)
    pad = w * 32 - k
    dev = o_lower.device
    powers = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev),
        torch.arange(32, dtype=torch.int64, device=dev))

    def pack(bits):                       # (..., k) bool → (..., w) words
        if pad:
            bits = torch.cat([bits, bits.new_zeros(*bits.shape[:-1], pad)], -1)
        return (bits.reshape(*bits.shape[:-1], w, 32).to(torch.int64)
                * powers).sum(-1)

    words = pack(o_lower)                 # (..., K, W)
    keep = torch.ones((*bs, k), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        kw = pack(keep)
        new = ~((words & kw[..., None, :]) != 0).any(-1)
        changed = bool((new != keep).any())
        keep = new
        if not changed:
            break
    return keep


def rotated_nms_matrix(boxes, scores, iou_thresh: float, pre_max: int,
                       post_max: int, score_thresh: float | None = None,
                       rounds: int = 32, matrix_cap: int = 2048):
    """Exact greedy rotated NMS over padded boxes, batched.

    boxes (..., N, 7), scores (..., N).  Returns keep_idx (..., post_max)
    int64 indices into the input (0 on padding), keep_valid (..., post_max)
    bool and keep_scores (..., post_max) (−1e10 on padding).  The matrix
    width is ``min(pre_max, N, matrix_cap)``.
    """
    n = boxes.shape[-2]
    if score_thresh is not None:
        scores = torch.where(scores >= score_thresh, scores,
                             torch.full_like(scores, _NEG_INF))
    k = min(pre_max, n, matrix_cap)
    top_scores, order = _top_k(scores, k)
    top_boxes = torch.gather(
        boxes[..., :7], -2, order[..., None].expand(*order.shape, 7))
    areas = top_boxes[..., 3] * top_boxes[..., 4]
    alive = top_scores > _NEG_INF / 2

    overlap = iou3d.boxes_overlap_bev(top_boxes, top_boxes)
    iou = overlap / torch.clamp(areas[..., :, None] + areas[..., None, :]
                                - overlap, min=1e-8)
    idx = torch.arange(k, device=boxes.device)
    o_lower = ((iou > iou_thresh) & (idx[None, :] < idx[:, None])
               & alive[..., None, :] & alive[..., :, None])
    keep = _suppress_fixpoint_packed(o_lower, rounds) & alive

    kept_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, _NEG_INF))
    keep_scores, kidx = _top_k(kept_scores, min(post_max, k))
    keep_valid = keep_scores > _NEG_INF / 2
    keep_idx = torch.where(keep_valid, torch.gather(order, -1, kidx),
                           torch.zeros_like(kidx))
    if post_max > k:
        pad = post_max - k
        keep_idx = torch.cat([keep_idx, keep_idx.new_zeros(*keep_idx.shape[:-1], pad)], -1)
        keep_valid = torch.cat([keep_valid, keep_valid.new_zeros(*keep_valid.shape[:-1], pad)], -1)
        keep_scores = torch.cat([keep_scores, keep_scores.new_full(
            (*keep_scores.shape[:-1], pad), _NEG_INF)], -1)
    return keep_idx, keep_valid, torch.where(
        keep_valid, keep_scores, torch.full_like(keep_scores, _NEG_INF))


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """Parity with ``model_nms_utils.class_agnostic_nms`` under fixed shapes."""
    return rotated_nms_matrix(
        box_preds, box_scores,
        iou_thresh=float(nms_config.NMS_THRESH),
        pre_max=int(nms_config.NMS_PRE_MAXSIZE),
        post_max=int(nms_config.NMS_POST_MAXSIZE),
        score_thresh=score_thresh,
        matrix_cap=int(nms_config.get('MATRIX_CAP', 2048)),
    )


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None):
    """Per-class NMS (parity ``model_nms_utils.multi_classes_nms:40-67``).

    cls_scores (..., A, C); box_preds (..., A, D) or per class (..., A, C, D).
    Returns stacked (..., C, post) scores / labels / valid / idx and
    (..., C, post, D) boxes; ``idx`` indexes the source anchor row.
    """
    num_classes = cls_scores.shape[-1]
    post = int(nms_config.NMS_POST_MAXSIZE)
    per_class_boxes = box_preds.ndim == cls_scores.ndim + 1
    out = {'scores': [], 'boxes': [], 'valid': [], 'labels': [], 'idx': []}
    for c in range(num_classes):
        s = cls_scores[..., c]
        b = box_preds[..., c, :] if per_class_boxes else box_preds
        idx, valid, scores = rotated_nms_matrix(
            b[..., :7], s, float(nms_config.NMS_THRESH),
            int(nms_config.NMS_PRE_MAXSIZE), post,
            score_thresh=score_thresh,
            matrix_cap=int(nms_config.get('MATRIX_CAP', 2048)))
        out['scores'].append(scores)
        out['boxes'].append(torch.gather(
            b, -2, idx[..., None].expand(*idx.shape, b.shape[-1])))
        out['valid'].append(valid)
        out['labels'].append(torch.full_like(idx, c + 1))
        out['idx'].append(idx)
    return (torch.stack(out['scores'], -2), torch.stack(out['labels'], -2),
            torch.stack(out['boxes'], -3), torch.stack(out['valid'], -2),
            torch.stack(out['idx'], -2))
