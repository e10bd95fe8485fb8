"""Axis-aligned anchor target assignment (torch, fixed shapes).

Port of ``AxisAlignedTargetAssigner`` from
``crb_active_3ddet_tpu/models/dense_heads/target_assigner.py:26-119``
(reference ``axis_aligned_target_assigner.py``).  All frames at once: the
IoU is (B, N, M) per anchor class, a gt box of another class or of the zero
padding gets IoU −1 and can never match, and the force match and the
thresholds are tensor ops, with no loop over frames and no host sync.  The
IoU is computed in the JAX package's order of operations, because the force
match compares IoUs for float equality; ``argmax`` takes the first maximum
in both frameworks.

Assumes POS_FRACTION < 0 (no subsampling), as the JAX assigner does.
"""

from __future__ import annotations

import torch

from ...ops.iou3d import boxes3d_nearest_bev_iou


class AxisAlignedTargetAssigner:
    def __init__(self, model_cfg, class_names, box_coder, match_height=False):
        anchor_generator_cfg = model_cfg['ANCHOR_GENERATOR_CONFIG']
        anchor_target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        self.box_coder = box_coder
        if match_height:
            raise NotImplementedError('MATCH_HEIGHT (3D IoU matching) is not '
                                      'ported yet')
        class_names = list(class_names)
        # class id (1-based, into class_names) each anchor set matches
        self.anchor_class_ids = [class_names.index(c['class_name']) + 1
                                 for c in anchor_generator_cfg]
        self.matched_thresholds = [float(c['matched_threshold'])
                                   for c in anchor_generator_cfg]
        self.unmatched_thresholds = [float(c['unmatched_threshold'])
                                     for c in anchor_generator_cfg]
        if not anchor_target_cfg['POS_FRACTION'] < 0:
            raise ValueError('the static-shape assigner requires POS_FRACTION < 0 '
                             '(no sampling)')
        self.norm_by_num_examples = anchor_target_cfg['NORM_BY_NUM_EXAMPLES']

    def assign_targets(self, anchors, anchors_per_location, gt_boxes_with_classes):
        """anchors (L, A, 7+): the head's flat anchors by location, the A of
        a location in class order (``anchors_per_location`` of each class);
        gt_boxes_with_classes (B, M, 8), zero-padded.

        Returns box_cls_labels (B, L·A) int32 (−1 ignore, 0 background, c
        foreground), box_reg_targets (B, L·A, code_size) and reg_weights
        (B, L·A), in the head's (location, class, size, rotation) order."""
        gt_boxes = gt_boxes_with_classes[..., :-1]
        gt_classes = gt_boxes_with_classes[..., -1].to(torch.int32)
        gt_valid = torch.abs(gt_boxes_with_classes).sum(dim=-1) > 0   # (B, M)
        per_class = []
        for cls_anchors, cls_id, m_th, u_th in zip(
                anchors.split(list(anchors_per_location), dim=1),
                self.anchor_class_ids, self.matched_thresholds,
                self.unmatched_thresholds):
            out = self._assign_class(cls_anchors.reshape(-1, anchors.shape[-1]),
                                     m_th, u_th, cls_id, gt_boxes, gt_classes,
                                     gt_valid)
            per_class.append({k: v.reshape(v.shape[0], anchors.shape[0], -1,
                                           *v.shape[2:]) for k, v in out.items()})
        b = gt_boxes.shape[0]
        return {
            'box_cls_labels': torch.cat([s['labels'] for s in per_class], 2).reshape(b, -1),
            'box_reg_targets': torch.cat([s['reg_targets'] for s in per_class], 2)
            .reshape(b, -1, self.box_coder.code_size),
            'reg_weights': torch.cat([s['reg_weights'] for s in per_class], 2).reshape(b, -1),
        }

    def _assign_class(self, anchors, matched_th, unmatched_th, cls_id,
                      gt_boxes, gt_classes, gt_valid):
        """One anchor class, every frame.  anchors (N, 7+); gt_boxes
        (B, M, 7+); gt_classes/gt_valid (B, M).  Returns (B, N[, code])."""
        class_mask = gt_valid & (gt_classes == cls_id)                  # (B, M)
        overlap = boxes3d_nearest_bev_iou(anchors[:, :7], gt_boxes[..., :7])  # (B, N, M)
        overlap = torch.where(class_mask[:, None, :], overlap, -1.0)

        anchor_to_gt_max, anchor_to_gt_argmax = overlap.max(dim=2)
        gt_to_anchor_max = overlap.max(dim=1).values                    # (B, M)
        # empty gts (max overlap 0) are not force-matched, as in the reference
        gt_to_anchor_max = torch.where(class_mask & (gt_to_anchor_max > 0),
                                       gt_to_anchor_max, -2.0)
        force_match = (overlap == gt_to_anchor_max[:, None, :]).any(dim=2)

        pos = anchor_to_gt_max >= matched_th
        bg = anchor_to_gt_max < unmatched_th
        fg = pos | force_match
        # label order of the reference: start −1, bg → 0, force/pos → cls_id
        labels = torch.full_like(anchor_to_gt_argmax, -1, dtype=torch.int32)
        labels = torch.where(bg, 0, labels)
        labels = torch.where(fg, cls_id, labels).to(torch.int32)

        matched_gt = torch.gather(
            gt_boxes, 1, anchor_to_gt_argmax[..., None].expand(
                -1, -1, gt_boxes.shape[-1]))                            # (B, N, 7+)
        reg_targets = torch.where(
            fg[..., None], self.box_coder.encode(matched_gt, anchors[None]), 0.0)

        reg_weights = fg.to(torch.float32)
        if self.norm_by_num_examples:
            num_examples = torch.clamp((labels >= 0).sum(dim=1, keepdim=True)
                                       .to(torch.float32), min=1.0)
            reg_weights = reg_weights / num_examples
        return {'labels': labels, 'reg_targets': reg_targets,
                'reg_weights': reg_weights}
