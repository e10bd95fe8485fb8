"""Lightweight 3D-IoU average precision for synthetic-scene tests.

Not a reference port — the KITTI-official R40 evaluator lives in
``datasets/kitti/kitti_eval``.  This is the quick oracle used by
SyntheticDataset.evaluation: greedy IoU matching per frame, 40-point AP.
"""

from __future__ import annotations

import numpy as np


def _bev_iou_matrix(boxes_a, boxes_b):
    import torch
    from ..ops.iou3d import boxes_iou3d
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    return boxes_iou3d(torch.from_numpy(np.asarray(boxes_a, np.float32)),
                       torch.from_numpy(np.asarray(boxes_b, np.float32))).numpy()


def evaluate_lidar_ap(det_annos, gt_annos, class_names, iou_thresh=0.5):
    """det_annos/gt_annos: per-frame dicts with boxes_lidar (N, 7) + name.
    Returns {f'{cls}_ap': AP} + mAP."""
    ap_dict = {}
    for cls in class_names:
        scores, matched, num_gt = [], [], 0
        for det, gt in zip(det_annos, gt_annos):
            det_mask = det['name'] == cls
            gt_mask = gt['name'] == cls
            det_boxes = det['boxes_lidar'][det_mask]
            det_scores = det['score'][det_mask]
            gt_boxes = gt['boxes_lidar'][gt_mask]
            num_gt += len(gt_boxes)
            if len(det_boxes) == 0:
                continue
            order = np.argsort(-det_scores)
            det_boxes, det_scores = det_boxes[order], det_scores[order]
            iou = _bev_iou_matrix(det_boxes, gt_boxes)
            taken = np.zeros(len(gt_boxes), bool)
            for i in range(len(det_boxes)):
                scores.append(det_scores[i])
                hit = False
                if len(gt_boxes):
                    j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                    if iou[i, j] >= iou_thresh and not taken[j]:
                        taken[j] = True
                        hit = True
                matched.append(hit)
        if num_gt == 0:
            ap_dict[f'{cls}_ap'] = 0.0
            continue
        if not scores:
            ap_dict[f'{cls}_ap'] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        matched = np.asarray(matched)[order]
        tp = np.cumsum(matched)
        fp = np.cumsum(~matched)
        recall = tp / num_gt
        precision = tp / np.maximum(tp + fp, 1)
        # 40-point interpolated AP (R40 style)
        ap = 0.0
        for t in np.linspace(0, 1, 41)[1:]:
            prec = precision[recall >= t]
            ap += (prec.max() if len(prec) else 0.0) / 40
        ap_dict[f'{cls}_ap'] = float(ap)
    ap_dict['mAP'] = float(np.mean([ap_dict[f'{c}_ap'] for c in class_names]))
    return ap_dict
