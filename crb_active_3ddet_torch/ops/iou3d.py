"""Rotated BEV overlap / IoU (torch).

Port of ``crb_active_3ddet_tpu/ops/iou3d.py`` (replacement for the reference
CUDA extension ``pcdet/ops/iou3d_nms``: ``boxes_overlap_bev_gpu``,
``boxes_iou_bev``, ``boxes_iou3d_gpu``).  The overlap goes through the
hand-written kernel's wrapper (``ops/cuda_overlap.py``): the CUDA kernel on a
card, its plain torch version on the CPU.  ``boxes3d_nearest_bev_iou`` (the
axis-aligned target assigner's IoU) is plain tensor arithmetic.  All functions take matching
leading batch dimensions: (..., N, 7) × (..., M, 7) → (..., N, M).

Box convention: (x, y, z, dx, dy, dz, heading) — see utils/box_utils.py.
"""

from __future__ import annotations

import torch

from .cuda_overlap import boxes_overlap_bev_cuda

_EPS = 1e-8


def boxes_overlap_bev(boxes_a, boxes_b):
    """Rotated BEV intersection areas (parity ``boxes_overlap_bev_gpu``)."""
    return boxes_overlap_bev_cuda(boxes_a, boxes_b)


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU (parity ``iou3d_nms_utils.boxes_iou_bev``)."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=_EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU: BEV rotated overlap × z overlap (parity
    ``iou3d_nms_utils.boxes_iou3d_gpu``, `iou3d_nms_utils.py:48-81`)."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_top = (boxes_a[..., 2] + boxes_a[..., 5] / 2)[..., :, None]
    a_bot = (boxes_a[..., 2] - boxes_a[..., 5] / 2)[..., :, None]
    b_top = (boxes_b[..., 2] + boxes_b[..., 5] / 2)[..., None, :]
    b_bot = (boxes_b[..., 2] - boxes_b[..., 5] / 2)[..., None, :]
    overlap_h = torch.clamp(torch.minimum(a_top, b_top)
                            - torch.maximum(a_bot, b_bot), min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=_EPS)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned BEV IoU after snapping each heading to the nearest axis
    (parity ``box_utils.boxes3d_nearest_bev_iou``), in the JAX package's
    order of operations (``ops/iou3d.py:153``), so that the assigner's
    float-equality force match ties as there."""
    def to_aabb(b):
        rot = torch.abs(torch.remainder(b[..., 6], torch.pi))
        swap = (rot > torch.pi / 4) & (rot < 3 * torch.pi / 4)
        dx = torch.where(swap, b[..., 4], b[..., 3])
        dy = torch.where(swap, b[..., 3], b[..., 4])
        return torch.stack([b[..., 0] - dx / 2, b[..., 1] - dy / 2,
                            b[..., 0] + dx / 2, b[..., 1] + dy / 2], dim=-1)

    aa, bb = to_aabb(boxes_a), to_aabb(boxes_b)
    x_min = torch.maximum(aa[..., :, None, 0], bb[..., None, :, 0])
    y_min = torch.maximum(aa[..., :, None, 1], bb[..., None, :, 1])
    x_max = torch.minimum(aa[..., :, None, 2], bb[..., None, :, 2])
    y_max = torch.minimum(aa[..., :, None, 3], bb[..., None, :, 3])
    inter = torch.clamp(x_max - x_min, min=0) * torch.clamp(y_max - y_min, min=0)
    area_a = ((aa[..., 2] - aa[..., 0]) * (aa[..., 3] - aa[..., 1]))[..., :, None]
    area_b = ((bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1]))[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)
