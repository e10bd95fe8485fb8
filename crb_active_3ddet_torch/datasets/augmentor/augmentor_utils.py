"""Geometric augmentation primitives (host-side numpy, dataloader workers).

Parity: ``pcdet/datasets/augmentor/augmentor_utils.py`` (random_flip_along_x/y,
global_rotation, global_scaling + local per-object variants).  Uses
``np.random`` like the reference (per-worker seeded)."""

from __future__ import annotations

import numpy as np

from ...utils.common import rotate_points_along_z_single


def random_flip_along_x(gt_boxes, points):
    """Flip across the x axis (negate y). 50% chance."""
    enable = np.random.choice([False, True], p=[0.5, 0.5])
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points):
    """Flip across the y axis (negate x). 50% chance."""
    enable = np.random.choice([False, True], p=[0.5, 0.5])
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range):
    noise_rotation = np.random.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z_single(points, noise_rotation)
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 0:3] = rotate_points_along_z_single(
        gt_boxes[:, 0:3], noise_rotation)
    gt_boxes[:, 6] += noise_rotation
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate([gt_boxes[:, 7:9],
                              np.zeros((gt_boxes.shape[0], 1), gt_boxes.dtype)], axis=1)
        gt_boxes[:, 7:9] = rotate_points_along_z_single(vel, noise_rotation)[:, :2]
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    noise_scale = np.random.uniform(scale_range[0], scale_range[1])
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= noise_scale
    gt_boxes[:, :6] *= noise_scale
    return gt_boxes, points


# ---------------------------------------------------------------------------
# world translation + local per-object augmentation
# (parity: augmentor_utils.py:124-242,312-392 — same random draws per box,
# our own vectorized expression)
# ---------------------------------------------------------------------------
def random_world_translation(gt_boxes, points, offset_std):
    """Translate the whole scene; offset_std: [sx, sy, sz] noise scales."""
    offset = np.array([np.random.normal(0, s) for s in offset_std])
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] += offset
    gt_boxes[:, :3] += offset
    return gt_boxes, points


def _points_in_box_mask(points, box):
    """(M,) bool membership of a single rotated box (host numpy)."""
    shift = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = shift[:, 0] * c - shift[:, 1] * s
    ly = shift[:, 0] * s + shift[:, 1] * c
    return ((np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
            & (np.abs(shift[:, 2]) <= box[5] / 2))


def random_local_translation(gt_boxes, points, offset_range, axes=('x', 'y', 'z')):
    """Per-object translation along the given axes (parity :178-242)."""
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    axis_idx = {'x': 0, 'y': 1, 'z': 2}
    for i, box in enumerate(gt_boxes):
        mask = _points_in_box_mask(points, box)
        for ax in axes:
            offset = np.random.uniform(offset_range[0], offset_range[1])
            j = axis_idx[ax]
            points[mask, j] += offset
            gt_boxes[i, j] += offset
    return gt_boxes, points


def local_rotation(gt_boxes, points, rot_range):
    """Per-object rotation of each box + its interior points about the box
    center (parity :346-392)."""
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    for i, box in enumerate(gt_boxes):
        angle = np.random.uniform(rot_range[0], rot_range[1])
        mask = _points_in_box_mask(points, box)
        center = box[:3].copy()
        local = points[mask].copy()
        local[:, :3] -= center
        points[mask] = rotate_points_along_z_single(local, angle)
        points[mask, :3] += center
        gt_boxes[i, 6] += angle
    return gt_boxes, points


def local_scaling(gt_boxes, points, scale_range):
    """Per-object scaling of interior points about the box center
    (parity :312-344)."""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    for i, box in enumerate(gt_boxes):
        scale = np.random.uniform(scale_range[0], scale_range[1])
        mask = _points_in_box_mask(points, box)
        points[mask, :3] = (points[mask, :3] - box[:3]) * scale + box[:3]
        gt_boxes[i, 3:6] *= scale
    return gt_boxes, points


# ---------------------------------------------------------------------------
# frustum dropout (parity :244-310 global, :394-472 local)
# ---------------------------------------------------------------------------
_FRUSTUM_AXIS = {'top': (2, 'above'), 'bottom': (2, 'below'),
                 'left': (1, 'above'), 'right': (1, 'below')}


def global_frustum_dropout(gt_boxes, points, intensity_range, direction):
    """Drop the outer slab of the scene along z (top/bottom) or y
    (left/right): threshold at intensity fraction of the extent."""
    axis, side = _FRUSTUM_AXIS[direction]
    intensity = np.random.uniform(intensity_range[0], intensity_range[1])
    lo, hi = points[:, axis].min(), points[:, axis].max()
    if side == 'above':
        thr = hi - intensity * (hi - lo)
        keep_p = points[:, axis] < thr
        keep_b = gt_boxes[:, axis] < thr
    else:
        thr = lo + intensity * (hi - lo)
        keep_p = points[:, axis] > thr
        keep_b = gt_boxes[:, axis] > thr
    return gt_boxes[keep_b], points[keep_p]


def local_frustum_dropout(gt_boxes, points, intensity_range, direction):
    """Per-object slab dropout within each box's own extent along the same
    axis conventions (parity :394-472)."""
    axis, side = _FRUSTUM_AXIS[direction]
    points = points.copy()
    keep = np.ones(len(points), bool)
    half = {2: 5, 1: 4}[axis]  # dz for z, dy for y
    for box in gt_boxes:
        intensity = np.random.uniform(intensity_range[0], intensity_range[1])
        lo = box[axis] - box[half] / 2
        hi = box[axis] + box[half] / 2
        mask = _points_in_box_mask(points, box)
        if side == 'above':
            thr = hi - intensity * (hi - lo)
            keep &= ~(mask & (points[:, axis] >= thr))
        else:
            thr = lo + intensity * (hi - lo)
            keep &= ~(mask & (points[:, axis] <= thr))
    return gt_boxes, points[keep]


# ---------------------------------------------------------------------------
# pyramid augmentation (parity :494-640) — each box splits into 6 surface
# pyramids (center → face); dropout removes a pyramid's points, sparsify
# subsamples them, swap exchanges points between the same face pyramid of
# two boxes by relative-coordinate transfer
# ---------------------------------------------------------------------------
def _box_pyramid_index(points, box):
    """For each point: (in_box mask, face index 0..5).  Faces order:
    +x, -x, +y, -y, +z, -z in the box frame."""
    shift = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = shift[:, 0] * c - shift[:, 1] * s
    ly = shift[:, 0] * s + shift[:, 1] * c
    lz = shift[:, 2]
    inside = ((np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
              & (np.abs(lz) <= box[5] / 2))
    # dominant normalized axis decides the face pyramid
    nx, ny, nz = (lx / max(box[3], 1e-6), ly / max(box[4], 1e-6),
                  lz / max(box[5], 1e-6))
    stacked = np.stack([nx, -nx, ny, -ny, nz, -nz], axis=1)
    face = stacked.argmax(axis=1)
    return inside, face, np.stack([nx, ny, nz], axis=1)


def local_pyramid_dropout(gt_boxes, points, dropout_prob):
    keep = np.ones(len(points), bool)
    for box in gt_boxes:
        if np.random.rand() > dropout_prob:
            continue
        face_drop = np.random.randint(6)
        inside, face, _ = _box_pyramid_index(points, box)
        keep &= ~(inside & (face == face_drop))
    return gt_boxes, points[keep]


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts):
    keep = np.ones(len(points), bool)
    for box in gt_boxes:
        if np.random.rand() > prob:
            continue
        face_sp = np.random.randint(6)
        inside, face, _ = _box_pyramid_index(points, box)
        idx = np.where(inside & (face == face_sp))[0]
        if len(idx) > max_num_pts:
            drop = np.random.choice(idx, len(idx) - max_num_pts,
                                    replace=False)
            keep[drop] = False
    return gt_boxes, points[keep]


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts):
    """Swap the points of a random face pyramid between two boxes by
    normalized-coordinate transfer (parity :585-640)."""
    n = len(gt_boxes)
    if n < 2:
        return gt_boxes, points
    points = points.copy()
    for i in range(n):
        if np.random.rand() > prob:
            continue
        j = np.random.randint(n)
        if j == i:
            continue
        face_sw = np.random.randint(6)
        ins_i, face_i, rel_i = _box_pyramid_index(points, gt_boxes[i])
        ins_j, face_j, rel_j = _box_pyramid_index(points, gt_boxes[j])
        sel_i = np.where(ins_i & (face_i == face_sw))[0][:max_num_pts]
        sel_j = np.where(ins_j & (face_j == face_sw))[0][:max_num_pts]
        if len(sel_i) == 0 or len(sel_j) == 0:
            continue

        def to_world(rel, box):
            local = rel * np.asarray([box[3], box[4], box[5]])
            pts = rotate_points_along_z_single(
                local.astype(points.dtype), box[6])
            return pts + box[:3]

        # move i's pyramid points into j's frame and vice versa
        points[sel_i, :3] = to_world(rel_i[sel_i], gt_boxes[j])
        points[sel_j, :3] = to_world(rel_j[sel_j], gt_boxes[i])
    return gt_boxes, points
