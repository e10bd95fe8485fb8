"""Box geometry utilities (host-side numpy; the corners and the enlarged
boxes also on torch tensors).

Copy of the numpy parts of ``crb_active_3ddet_tpu/utils/box_utils.py``
(reference parity: ``pcdet/utils/box_utils.py`` boxes_to_corners_3d
:211-233, mask_boxes_outside_range_numpy :11-33, remove_points_in_boxes3d,
boxes3d_kitti_camera_to_lidar :107-125, boxes3d_lidar_to_kitti_camera
:128-150, boxes3d_kitti_camera_to_imageboxes :153-177, enlarge_box3d
:236-249, in_hull).

Box convention: ``(x, y, z, dx, dy, dz, heading)`` with (x, y, z) the box
center, dx/dy/dz the full sizes along the box's local x, y, z axes, and
heading the rotation around +z (counter-clockwise, 0 along +x).
"""

from __future__ import annotations

import numpy as np
import torch

from . import common

# Template of the 8 corner offsets in the box local frame, in the reference's
# corner order (box_utils.boxes_to_corners_3d template).
_CORNER_TEMPLATE = np.array([
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
], dtype=np.float32) / 2.0


def boxes_to_corners_3d(boxes3d):
    """(N, 7) boxes → (N, 8, 3) corners; numpy arrays or torch tensors."""
    template = _CORNER_TEMPLATE
    if isinstance(boxes3d, torch.Tensor):
        template = torch.from_numpy(template).to(boxes3d)
    corners = boxes3d[:, None, 3:6] * template[None, :, :]  # (N, 8, 3)
    corners = common.rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def corners_bev(boxes):
    """(..., 7) boxes → (..., 4, 2) BEV corners (x, y), CCW order."""
    dx, dy, heading = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    # local corners (CCW): (+,+), (-,+), (-,-), (+,-)
    sx = np.stack([dx, -dx, -dx, dx], axis=-1) / 2.0
    sy = np.stack([dy, dy, -dy, -dy], axis=-1) / 2.0
    cosa = np.cos(heading)[..., None]
    sina = np.sin(heading)[..., None]
    cx = sx * cosa - sy * sina + boxes[..., None, 0]
    cy = sx * sina + sy * cosa + boxes[..., None, 1]
    return np.stack([cx, cy], axis=-1)


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """Keep boxes with >= min_num_corners corners inside limit_range.

    Mirrors ``box_utils.mask_boxes_outside_range_numpy``.
    """
    if boxes.shape[1] > 7:
        boxes = boxes[:, :7]
    corners = boxes_to_corners_3d(boxes)  # (N, 8, 3)
    mask = ((corners >= np.asarray(limit_range[0:3])) &
            (corners <= np.asarray(limit_range[3:6]))).all(axis=2)
    return mask.sum(axis=1) >= min_num_corners


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """Grow each box by extra_width on each size axis (reference :236-249).
    A torch tensor may have any leading axes, (..., M, 7+)."""
    if isinstance(boxes3d, torch.Tensor):
        extra = torch.tensor(extra_width, dtype=boxes3d.dtype, device=boxes3d.device)
        return torch.cat([boxes3d[..., :3], boxes3d[..., 3:6] + extra,
                          boxes3d[..., 6:]], dim=-1)
    out = np.asarray(boxes3d).copy()
    out[:, 3:6] += np.asarray(extra_width, dtype=out.dtype)
    return out


# ---------------------------------------------------------------------------
# KITTI camera <-> lidar conversions (need a calib object with
# rect_to_lidar / lidar_to_rect / rect_to_img like the reference's Calibration)
# ---------------------------------------------------------------------------

def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x, y, z, l, h, w, r] in camera rect → (N, 7) lidar boxes.

    Mirrors ``box_utils.boxes3d_kitti_camera_to_lidar:107-125``.
    """
    boxes3d_camera = boxes3d_camera.copy()
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], boxes3d_camera[:, 5:6]
    r = boxes3d_camera[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2  # camera y is box bottom → lidar z center
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """(N, 7) lidar boxes → (N, 7) camera [x, y, z, l, h, w, r].

    Mirrors ``box_utils.boxes3d_lidar_to_kitti_camera:128-150``.
    """
    boxes3d_lidar = boxes3d_lidar.copy()
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r_cam = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r_cam], axis=-1)


def boxes3d_kitti_camera_to_imageboxes(boxes3d_camera, calib, image_shape=None):
    """Camera-frame 3D boxes → 2D image boxes (x1, y1, x2, y2).

    Mirrors ``box_utils.boxes3d_kitti_camera_to_imageboxes:153-177``.
    """
    corners3d = boxes3d_camera_to_corners3d(boxes3d_camera)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_in_image = pts_img.reshape(-1, 8, 2)

    min_uv = np.min(corners_in_image, axis=1)
    max_uv = np.max(corners_in_image, axis=1)
    boxes2d_image = np.concatenate([min_uv, max_uv], axis=1)
    if image_shape is not None:
        boxes2d_image[:, 0] = np.clip(boxes2d_image[:, 0], 0, image_shape[1] - 1)
        boxes2d_image[:, 1] = np.clip(boxes2d_image[:, 1], 0, image_shape[0] - 1)
        boxes2d_image[:, 2] = np.clip(boxes2d_image[:, 2], 0, image_shape[1] - 1)
        boxes2d_image[:, 3] = np.clip(boxes2d_image[:, 3], 0, image_shape[0] - 1)
    return boxes2d_image


def boxes3d_camera_to_corners3d(boxes3d):
    """(N, 7) camera boxes [x, y, z, l, h, w, ry] → (N, 8, 3) corners.

    Camera frame: x right, y down, z forward; box (x,y,z) is the bottom center.
    """
    boxes3d = np.asarray(boxes3d)
    l, h, w = boxes3d[:, 3:4], boxes3d[:, 4:5], boxes3d[:, 5:6]
    x_corners = np.concatenate([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], axis=1)
    z_corners = np.concatenate([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], axis=1)
    y_corners = np.concatenate([np.zeros_like(l), np.zeros_like(l), np.zeros_like(l), np.zeros_like(l),
                                -h, -h, -h, -h], axis=1)
    ry = boxes3d[:, 6]
    cosa, sina = np.cos(ry), np.sin(ry)
    # rotation about camera y axis
    x_rot = cosa[:, None] * x_corners + sina[:, None] * z_corners
    z_rot = -sina[:, None] * x_corners + cosa[:, None] * z_corners
    corners = np.stack([x_rot, y_corners, z_rot], axis=2)  # (N, 8, 3)
    return corners + boxes3d[:, None, 0:3]


def remove_points_in_boxes3d(points, boxes3d):
    """Drop points inside any of the boxes (host-side numpy, augmentor use)."""
    from ..ops.points_in_boxes import points_in_boxes_numpy
    if boxes3d.shape[0] == 0 or points.shape[0] == 0:
        return points
    mask = points_in_boxes_numpy(points[:, :3], boxes3d[:, :7])  # (N, M) bool
    return points[~mask.any(axis=1)]


def in_hull(p, hull):
    """Point-in-convex-hull test via Delaunay (reference box_utils.in_hull)."""
    from scipy.spatial import Delaunay
    if not isinstance(hull, Delaunay):
        hull = Delaunay(hull)
    return hull.find_simplex(p) >= 0
