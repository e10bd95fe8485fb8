"""Loss functions (torch). Port of ``crb_active_3ddet_tpu/utils/loss_utils.py``
:16-90, the anchor head's losses and the RoI head's BCE and corner loss
(reference ``pcdet/utils/loss_utils.py``).

Every loss is elementwise or per anchor and returns an unreduced tensor, so
that the caller applies the weighting and keeps the ``reduce=False``
per-sample mode that BADGE, CRB and llal read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import box_utils


def binary_cross_entropy_with_logits(input, target):
    """Numerically stable, unreduced BCE with logits, in the JAX order (the
    RoI head's cls loss and the focal loss's BCE)."""
    return (torch.clamp(input, min=0) - input * target
            + torch.log1p(torch.exp(-torch.abs(input))))


def sigmoid_focal_cls_loss(input, target, weights, gamma: float = 2.0,
                           alpha: float = 0.25):
    """Sigmoid focal loss.  input/target (B, A, C); weights (B, A) or
    (B, A, C).  Returns the (B, A, C) weighted loss."""
    pred_sigmoid = torch.sigmoid(input)
    alpha_weight = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - pred_sigmoid) + (1.0 - target) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    loss = focal_weight * binary_cross_entropy_with_logits(input, target)
    if weights.ndim == loss.ndim - 1:
        weights = weights[..., None]
    return loss * weights


def smooth_l1_loss(diff, beta: float = 1.0 / 9.0):
    if beta < 1e-5:
        return torch.abs(diff)
    n = torch.abs(diff)
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def _coded_diff(input, target, code_weights):
    target = torch.where(torch.isnan(target), input, target)
    diff = input - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    return diff


def weighted_smooth_l1_loss(input, target, weights=None, beta: float = 1.0 / 9.0,
                            code_weights=None):
    """input/target (B, A, D); weights (B, A).  Returns (B, A, D)."""
    loss = smooth_l1_loss(_coded_diff(input, target, code_weights), beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_l1_loss(input, target, weights=None, code_weights=None):
    """input/target (B, A, D); weights (B, A).  Returns (B, A, D)."""
    loss = torch.abs(_coded_diff(input, target, code_weights))
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy_loss(input, target, weights):
    """input (B, A, C) logits; target (B, A, C) one-hot; weights (B, A).
    Returns (B, A)."""
    return -(target * F.log_softmax(input, dim=-1)).sum(dim=-1) * weights


def get_corner_loss_lidar(pred_bbox3d, gt_bbox3d):
    """Corner loss against the nearer of the gt box and the gt box turned by
    π: pred/gt (N, 7) → (N,) smooth-L1 (beta 1) of each corner's distance,
    averaged over the 8 corners (reference ``loss_utils.py:210-239``)."""
    pred_corners = box_utils.boxes_to_corners_3d(pred_bbox3d)
    gt_corners = box_utils.boxes_to_corners_3d(gt_bbox3d)
    gt_flip = torch.cat([gt_bbox3d[:, :6], gt_bbox3d[:, 6:7] + np.pi], dim=1)
    gt_corners_flip = box_utils.boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(torch.linalg.norm(pred_corners - gt_corners, dim=-1),
                         torch.linalg.norm(pred_corners - gt_corners_flip, dim=-1))
    return smooth_l1_loss(dist, beta=1.0).mean(dim=1)
