"""Points-in-rotated-boxes tests + per-box point statistics (torch).

Port of ``crb_active_3ddet_tpu/ops/points_in_boxes.py`` (the replacement for
``pcdet/ops/roiaware_pool3d`` ``points_in_boxes_cpu/gpu``, plus the per-box
``pred_box_unique_density`` of ``detector3d_template.py:379-387``).  The whole
(N, M) membership matrix is one elementwise tensor expression; padded points
and boxes carry validity masks.
"""

from __future__ import annotations

import numpy as np
import torch


def points_in_boxes(points, boxes):
    """(..., N, 3+) points, (..., M, 7) boxes → (..., N, M) bool membership."""
    px, py, pz = points[..., :, 0:1], points[..., :, 1:2], points[..., :, 2:3]
    cosa = torch.cos(-boxes[..., 6]).unsqueeze(-2)
    sina = torch.sin(-boxes[..., 6]).unsqueeze(-2)
    shift_x = px - boxes[..., 0].unsqueeze(-2)
    shift_y = py - boxes[..., 1].unsqueeze(-2)
    shift_z = pz - boxes[..., 2].unsqueeze(-2)
    local_x = shift_x * cosa - shift_y * sina
    local_y = shift_x * sina + shift_y * cosa
    return ((torch.abs(shift_z) <= boxes[..., 5].unsqueeze(-2) / 2.0)
            & (torch.abs(local_x) <= boxes[..., 3].unsqueeze(-2) / 2.0)
            & (torch.abs(local_y) <= boxes[..., 4].unsqueeze(-2) / 2.0))


def points_count_per_box(points, boxes, points_valid=None, boxes_valid=None):
    """(..., M) number of (valid) points inside each (valid) box."""
    member = points_in_boxes(points, boxes)
    if points_valid is not None:
        member &= points_valid.unsqueeze(-1)
    counts = member.sum(dim=-2).to(torch.float32)
    if boxes_valid is not None:
        counts = torch.where(boxes_valid, counts, torch.zeros_like(counts))
    return counts


def box_point_density(points, boxes, points_valid=None, boxes_valid=None):
    """Per-box "unique density" = #points inside / box volume.

    Parity: ``detector3d_template.py:379-387`` (``pred_box_unique_density``).
    Takes batch dimensions in front: (..., N, 3+) points, (..., M, 7) boxes.
    """
    counts = points_count_per_box(points, boxes, points_valid, boxes_valid)
    volume = boxes[..., 3] * boxes[..., 4] * boxes[..., 5]
    dens = counts / torch.clamp(volume, min=1e-6)
    if boxes_valid is not None:
        dens = torch.where(boxes_valid, dens, torch.zeros_like(dens))
    return dens


def points_in_boxes_numpy(points, boxes):
    """Host-side numpy (N, M) membership (augmentor / gt-database path).

    Parity: ``roiaware_pool3d_utils.points_in_boxes_cpu``.
    """
    px, py, pz = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    cosa = np.cos(-boxes[:, 6])[None, :]
    sina = np.sin(-boxes[:, 6])[None, :]
    shift_x = px - boxes[None, :, 0]
    shift_y = py - boxes[None, :, 1]
    shift_z = pz - boxes[None, :, 2]
    local_x = shift_x * cosa - shift_y * sina
    local_y = shift_x * sina + shift_y * cosa
    return ((np.abs(shift_z) <= boxes[None, :, 5] / 2.0)
            & (np.abs(local_x) <= boxes[None, :, 3] / 2.0)
            & (np.abs(local_y) <= boxes[None, :, 4] / 2.0))
