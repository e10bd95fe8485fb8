"""RoI head machinery (torch): the proposal layer and the box decoding of
``crb_active_3ddet_tpu/models/roi_heads/roi_head_template.py`` (:33, :290;
reference ``pcdet/models/roi_heads/roi_head_template.py``), batched over
frames.  Target sampling and the losses come with the train step.
"""

from __future__ import annotations

import torch

from ...ops import nms as nms_ops
from ...utils import common
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


def generate_predicted_boxes(rois, cls_preds, box_preds):
    """Decode rcnn predictions back to global boxes.  rois (B, R, 7);
    cls_preds (B·R, C); box_preds (B·R, 7) → (B, R, C), (B, R, 7)."""
    b, r = rois.shape[:2]
    roi_flat = rois.reshape(-1, 7)
    anchors0 = torch.cat([torch.zeros_like(roi_flat[:, :3]), roi_flat[:, 3:]], -1)
    local = _CODER.decode(box_preds.reshape(-1, 7), anchors0)
    rotated = common.rotate_points_along_z(
        local[:, None, :], roi_flat[:, 6]).reshape(-1, 7)
    boxes = torch.cat([rotated[:, :3] + roi_flat[:, :3], rotated[:, 3:]], -1)
    return cls_preds.reshape(b, r, -1), boxes.reshape(b, r, 7)
