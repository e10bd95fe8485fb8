"""Anchor target assignment (torch, fixed shapes).

Port of ``AxisAlignedTargetAssigner`` and ``ATSSTargetAssigner`` from
``crb_active_3ddet_tpu/models/dense_heads/target_assigner.py:26-119,122-204``
(reference ``axis_aligned_target_assigner.py``, ``atss_target_assigner.py``).
All frames at once: the IoU is (B, N, M), a gt box of the zero padding (and,
axis-aligned, of another class) can never match, and the matching rules are
tensor ops, with no loop over frames and no host sync.  The IoU is computed
in the JAX package's order of operations, because the force match compares
IoUs for float equality; ``argmax`` takes the first maximum in both
frameworks.  ``MATCH_HEIGHT`` matches by the 3D IoU (``boxes_iou3d``: one
launch of the overlap kernel an anchor class on a card) where the
axis-aligned assigner otherwise snaps every box to the nearest axis; ATSS
matches by the rotated BEV IoU (one launch over every anchor), or by the
3D one with ``MATCH_HEIGHT``.

The axis-aligned assigner assumes POS_FRACTION < 0 (no subsampling), as
the JAX one does.
"""

from __future__ import annotations

import torch

from ...ops.iou3d import boxes3d_nearest_bev_iou, boxes_iou3d, boxes_iou_bev

_BIG = 1e9          # ATSS: the centre distance of a padded gt
_NEG_INF = -1e9     # ATSS: the IoU of an anchor that is no gt's candidate


class AxisAlignedTargetAssigner:
    def __init__(self, model_cfg, class_names, box_coder, match_height=False):
        anchor_generator_cfg = model_cfg['ANCHOR_GENERATOR_CONFIG']
        anchor_target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        self.box_coder = box_coder
        self.match_height = bool(match_height)
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
        if self.match_height:
            overlap = boxes_iou3d(anchors[None, :, :7].expand(gt_boxes.shape[0], -1, -1),
                                  gt_boxes[..., :7])                    # (B, N, M)
        else:
            overlap = boxes3d_nearest_bev_iou(anchors[:, :7], gt_boxes[..., :7])
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


class ATSSTargetAssigner:
    """Adaptive Training Sample Selection (arXiv:1912.02424), as the JAX
    assigner has it: each gt's ``TOPK`` anchors nearest by centre distance
    are its candidates; a candidate is positive when its IoU reaches the
    candidates' mean + std (ddof 1) + 1e-6 and its centre lies in the gt's
    footprint (local x against dy / 2, local y against dx / 2: the
    reference's swap, kept); an anchor positive for several gts takes the
    one of largest IoU; then each valid gt claims its best-IoU anchor.
    Every other anchor is background (label 0; no anchor is ignored), and
    ``NORM_BY_NUM_EXAMPLES`` does not apply.

    Where JAX leaves an order to its scatters or sorts, the port fixes it:
    candidates tied in distance go to the lower anchor index (the order of
    ``jax.lax.top_k``), and of several gts that claim the same best anchor
    the one of highest index wins (the last write of a serial scatter)."""

    def __init__(self, model_cfg, class_names, box_coder, match_height=False,
                 topk=9):
        self.topk = int(model_cfg['TARGET_ASSIGNER_CONFIG'].get('TOPK', topk))
        self.box_coder = box_coder
        self.match_height = bool(match_height)

    def assign_targets(self, anchors, anchors_per_location, gt_boxes_with_classes):
        """The axis-aligned assigner's arguments and outputs: anchors
        (L, A, 7+) in the head's order, gt (B, M, 8) zero-padded →
        box_cls_labels (B, L·A) int32, box_reg_targets, reg_weights."""
        anchors = anchors.reshape(-1, anchors.shape[-1])[:, :7]          # (N, 7)
        n = anchors.shape[0]
        gt = gt_boxes_with_classes[..., :7]
        gt_cls = gt_boxes_with_classes[..., -1].to(torch.int32)
        valid = torch.abs(gt_boxes_with_classes).sum(dim=-1) > 0        # (B, M)
        b, m = valid.shape
        dev = gt.device
        iou_fn = boxes_iou3d if self.match_height else boxes_iou_bev
        ious = iou_fn(anchors[None].expand(b, -1, -1), gt)              # (B, N, M)
        ious = torch.where(valid[:, None, :], ious, 0.0)
        d = anchors[None, :, None, :3] - gt[:, None, :, :3]             # (B, N, M, 3)
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                          + d[..., 2] * d[..., 2])
        dist = torch.where(valid[:, None, :], dist, _BIG)
        k = min(self.topk, n)
        # the k nearest of each gt, ties to the lower index (jax.lax.top_k)
        idx = torch.sort(dist.transpose(1, 2), dim=-1, stable=True).indices[..., :k]
        cand = torch.gather(ious.transpose(1, 2), 2, idx)               # (B, M, K)
        thr = cand.mean(-1) + cand.std(-1, correction=1) + 1e-6
        is_pos = cand >= thr[..., None]
        # candidate centres inside the gt footprint (the reference's swap)
        cand_xyz = anchors[idx][..., :3] - gt[:, :, None, :3]           # (B, M, K, 3)
        cosg = torch.cos(-gt[..., 6])[..., None]
        sing = torch.sin(-gt[..., 6])[..., None]
        lx = cand_xyz[..., 0] * cosg - cand_xyz[..., 1] * sing
        ly = cand_xyz[..., 0] * sing + cand_xyz[..., 1] * cosg
        in_gt = (torch.abs(lx) <= gt[..., 4:5] / 2) & (torch.abs(ly) <= gt[..., 3:4] / 2)
        is_pos = is_pos & in_gt & valid[..., None]

        pos_mask = torch.zeros(b, m, n, dtype=torch.bool, device=dev).scatter_(
            2, idx, is_pos).transpose(1, 2)                             # (B, N, M)
        a2g_val, a2g_idx = torch.where(pos_mask, ious, _NEG_INF).max(dim=2)
        # each valid gt claims its best anchor; a padded gt writes to slot n,
        # which is dropped; of gts sharing an anchor the highest index wins
        best_val, best_anchor = ious.max(dim=1)                         # (B, M)
        best_anchor = torch.where(valid, best_anchor, n)
        gt_ids = torch.arange(m, device=dev).expand(b, -1)
        claim = torch.full((b, n + 1), -1, dtype=torch.int64, device=dev).scatter_reduce(
            1, best_anchor, gt_ids, 'amax')[:, :n]                      # (B, N)
        claimed = claim >= 0
        a2g_idx = torch.where(claimed, claim, a2g_idx)
        a2g_val = torch.where(claimed, torch.gather(best_val, 1, claim.clamp(min=0)),
                              a2g_val)

        pos = a2g_val > _NEG_INF
        cls_labels = torch.where(pos, torch.gather(gt_cls, 1, a2g_idx), 0)
        matched = torch.gather(gt, 1, a2g_idx[..., None].expand(-1, -1, gt.shape[-1]))
        reg_targets = torch.where(pos[..., None],
                                  self.box_coder.encode(matched, anchors[None]), 0.0)
        return {'box_cls_labels': cls_labels.to(torch.int32),
                'box_reg_targets': reg_targets,
                'reg_weights': pos.to(torch.float32)}
