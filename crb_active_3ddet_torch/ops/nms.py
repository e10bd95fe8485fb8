"""Exact rotated NMS as a fixpoint over the overlap matrix (torch).

Port of ``crb_active_3ddet_tpu/ops/nms.py`` (``rotated_nms_matrix`` :174,
``_suppress_fixpoint_packed`` :132, ``class_agnostic_nms``,
``multi_classes_nms``), the replacement for the reference CUDA bitmask NMS
(``pcdet/ops/iou3d_nms/src/iou3d_nms_kernel.cu:267``; Python surface
``model_nms_utils.class_agnostic_nms`` / ``multi_classes_nms``).

Greedy NMS keeps exactly the boxes solving
    keep_i = NOT OR_{j<i, iou(i,j)>t} keep_j          (score-descending i),
reached by iterating from all-kept.  The suppression matrix (j < i, both
alive, iou(i, j) > t) comes as 32-bit words from ``ops/cuda_overlap.nms_mask``:
on a card one launch of the hand-written kernel for the whole batch, which
computes the corners, clips only the pairs that can overlap and applies the
IoU threshold and the masks itself, so no (K, K) float matrix is made.
Reference behaviours kept on purpose: boxes ranked below
``matrix_cap`` never enter the kept set, and the fixpoint stops after
``rounds`` rounds.  ``jax.lax.top_k`` becomes a stable descending sort: ties
go to the lowest index, as in XLA.
"""

from __future__ import annotations

import torch

from .cuda_overlap import nms_mask, pack_bits

_NEG_INF = -1e10


def _top_k(x, k):
    """Descending top-k along the last dim; ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_fixpoint_packed(o_lower, rounds: int):
    """Greedy-NMS fixpoint on a (..., K, K) bool suppression matrix, [i, j]
    True iff j < i, both alive and iou(i, j) > thresh: its columns packed
    32 to a word, then ``_fixpoint_words``.  Returns keep (..., K) bool."""
    return _fixpoint_words(pack_bits(o_lower), rounds)[0]


def _fixpoint_words(words, rounds: int):
    """Greedy-NMS fixpoint on (..., K, W) int32 suppression words (bit
    j mod 32 of word j // 32 of row i: box j suppresses box i if kept).

    Returns (keep (..., K) bool, rounds run).  The loop stops when no batch
    entry changes or after ``rounds`` rounds (a converged entry does not
    change in further rounds, so stopping on the whole batch equals stopping
    per entry); each round reads back one flag to the host.
    """
    keep = torch.ones(words.shape[:-1], dtype=torch.bool, device=words.device)
    for r in range(rounds):
        new = ~((words & pack_bits(keep)[..., None, :]) != 0).any(-1)
        changed = bool((new != keep).any())
        keep = new
        if not changed:
            return keep, r + 1
    return keep, rounds


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
    alive = top_scores > _NEG_INF / 2
    keep = _fixpoint_words(nms_mask(top_boxes, alive, iou_thresh), rounds)[0] & alive

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
