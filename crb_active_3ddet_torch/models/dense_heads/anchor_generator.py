"""Anchor generation (host-side numpy; anchors are static model constants).

Parity: ``pcdet/models/dense_heads/target_assigner/anchor_generator.py:17-62``.
Produces per-class anchor grids of shape (nz=1, ny, nx, num_size, num_rot, 7)
whose flattened concatenation (cat along the size axis, matching the
reference's ``torch.cat(self.anchors, dim=-3)`` in
``anchor_head_template.py:186-190``) lines up with the conv head's
(B, H, W, A·C) channel layout.
"""

from __future__ import annotations

import numpy as np


class AnchorGenerator:
    def __init__(self, anchor_range, anchor_generator_config):
        self.anchor_generator_cfg = anchor_generator_config
        self.anchor_range = anchor_range
        self.anchor_sizes = [c['anchor_sizes'] for c in anchor_generator_config]
        self.anchor_rotations = [c['anchor_rotations'] for c in anchor_generator_config]
        self.anchor_heights = [c['anchor_bottom_heights'] for c in anchor_generator_config]
        self.align_center = [c.get('align_center', False) for c in anchor_generator_config]
        self.num_of_anchor_sets = len(self.anchor_sizes)

    def generate_anchors(self, grid_sizes):
        """grid_sizes: per-class [nx, ny] feature-map sizes.

        Returns (anchors_list, num_anchors_per_location_list) with each entry
        of shape (1, ny, nx, num_size, num_rot, 7), float32.
        """
        assert len(grid_sizes) == self.num_of_anchor_sets
        all_anchors, num_anchors_per_location = [], []
        rng = self.anchor_range
        for grid_size, sizes, rotations, heights, align_center in zip(
                grid_sizes, self.anchor_sizes, self.anchor_rotations,
                self.anchor_heights, self.align_center):
            num_anchors_per_location.append(len(rotations) * len(sizes) * len(heights))
            if align_center:
                x_stride = (rng[3] - rng[0]) / grid_size[0]
                y_stride = (rng[4] - rng[1]) / grid_size[1]
                x_offset, y_offset = x_stride / 2, y_stride / 2
            else:
                x_stride = (rng[3] - rng[0]) / (grid_size[0] - 1)
                y_stride = (rng[4] - rng[1]) / (grid_size[1] - 1)
                x_offset, y_offset = 0, 0

            x_shifts = np.arange(rng[0] + x_offset, rng[3] + 1e-5, x_stride, dtype=np.float32)
            y_shifts = np.arange(rng[1] + y_offset, rng[4] + 1e-5, y_stride, dtype=np.float32)
            z_shifts = np.asarray(heights, np.float32)
            sizes_a = np.asarray(sizes, np.float32)          # (S, 3)
            rots_a = np.asarray(rotations, np.float32)       # (R,)
            num_size, num_rot = sizes_a.shape[0], rots_a.shape[0]

            xg, yg, zg = np.meshgrid(x_shifts, y_shifts, z_shifts, indexing='ij')
            centers = np.stack([xg, yg, zg], axis=-1)        # (nx, ny, nz, 3)
            a = np.tile(centers[:, :, :, None, :], (1, 1, 1, num_size, 1))
            sz = np.broadcast_to(sizes_a[None, None, None], (*a.shape[:4], 3))
            a = np.concatenate([a, sz], axis=-1)             # (nx, ny, nz, S, 6)
            a = np.tile(a[:, :, :, :, None, :], (1, 1, 1, 1, num_rot, 1))
            rot = np.broadcast_to(rots_a[None, None, None, None, :, None],
                                  (*a.shape[:5], 1))
            a = np.concatenate([a, rot], axis=-1)            # (nx, ny, nz, S, R, 7)
            a = np.ascontiguousarray(a.transpose(2, 1, 0, 3, 4, 5))  # (nz, ny, nx, S, R, 7)
            a[..., 2] += a[..., 5] / 2  # bottom height → box center z
            all_anchors.append(a.astype(np.float32))
        return all_anchors, num_anchors_per_location


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim: int = 7):
    """Parity: ``AnchorHeadTemplate.generate_anchors``
    (`anchor_head_template.py:38-52`). grid_size: full voxel grid [nx, ny, nz].
    """
    gen = AnchorGenerator(point_cloud_range, anchor_generator_cfg)
    feature_map_size = [np.asarray(grid_size[:2]) // c['feature_map_stride']
                        for c in anchor_generator_cfg]
    anchors_list, num_per_loc = gen.generate_anchors(feature_map_size)
    if anchor_ndim != 7:
        anchors_list = [
            np.concatenate([a, np.zeros((*a.shape[:-1], anchor_ndim - 7), np.float32)], axis=-1)
            for a in anchors_list]
    return anchors_list, num_per_loc
