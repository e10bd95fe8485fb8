"""Config-driven per-sample processing queue (host-side numpy).

Parity: ``pcdet/datasets/processor/data_processor.py:63-211`` —
mask_points_and_boxes_outside_range, shuffle_points, sample_points, and
``transform_points_to_voxels``.

TPU-first delta: voxelization does NOT run here.  The processor only records
the voxel config (voxel_size / caps / grid_size); the train/eval loop
voxelizes **on device inside jit** (``ops.voxelize``), keeping dataloader
workers cheap and the whole point→voxel→VFE path fused.  What this stage does
instead is pad/truncate points to the fixed MAX_POINTS_PER_FRAME buffer.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ...ops.voxelize import grid_size_from_range
from ...utils import box_utils


DEFAULT_MAX_POINTS = {'train': 16384, 'test': 40960}


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = 'train' if training else 'test'
        self.grid_size = self.voxel_size = None
        self.voxel_cfg = None
        self.max_points_per_frame = DEFAULT_MAX_POINTS[self.mode]
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            self.data_processor_queue.append(
                getattr(self, cur_cfg.NAME)(config=cur_cfg))

    # each method doubles as factory (config=) and processor (data_dict=),
    # mirroring the reference's partial-dispatch pattern
    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        if data_dict.get('points', None) is not None:
            pts = data_dict['points']
            mask = ((pts[:, 0] >= self.point_cloud_range[0])
                    & (pts[:, 0] <= self.point_cloud_range[3])
                    & (pts[:, 1] >= self.point_cloud_range[1])
                    & (pts[:, 1] <= self.point_cloud_range[4]))
            data_dict['points'] = pts[mask]
        if data_dict.get('gt_boxes', None) is not None and config.REMOVE_OUTSIDE_BOXES \
                and self.training:
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict['gt_boxes'], self.point_cloud_range,
                min_num_corners=config.get('min_num_corners', 1))
            data_dict['gt_boxes'] = data_dict['gt_boxes'][mask]
            if 'gt_names' in data_dict:
                data_dict['gt_names'] = data_dict['gt_names'][mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            points = data_dict['points']
            idx = np.random.permutation(points.shape[0])
            data_dict['points'] = points[idx]
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config.NUM_POINTS[self.mode]
        if num_points == -1:
            return data_dict
        points = data_dict['points']
        if num_points < len(points):
            depth = np.linalg.norm(points[:, 0:3], axis=1)
            near_mask = depth < 40.0
            far_idx = np.where(~near_mask)[0]
            near_idx = np.where(near_mask)[0]
            choice = near_idx if num_points > len(far_idx) else np.array([], np.int64)
            if num_points > len(far_idx):
                near_choice = np.random.choice(
                    near_idx, num_points - len(far_idx), replace=False)
                choice = np.concatenate([near_choice, far_idx])
            else:
                choice = np.random.choice(
                    np.arange(len(points)), num_points, replace=False)
            np.random.shuffle(choice)
            data_dict['points'] = points[choice]
        else:
            choice = np.arange(len(points))
            if num_points > len(points):
                extra = np.random.choice(choice, num_points - len(points),
                                         replace=len(points) < num_points - len(points))
                choice = np.concatenate([choice, extra])
            np.random.shuffle(choice)
            data_dict['points'] = points[choice]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        """Record voxel config; actual voxelization is a device-side jitted op
        (ops/voxelize.py) fused into the model step."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            self.grid_size = np.asarray(grid_size_from_range(
                self.point_cloud_range, self.voxel_size), np.int64)
            max_voxels = int(config.MAX_NUMBER_OF_VOXELS[self.mode])
            # VOXEL_BUFFER_CAP (TPU delta): the reference's spconv processes
            # only the ACTUAL voxels of a scan (dynamic shapes); our fixed
            # (max_voxels, K, C) buffer processes every slot.  When
            # MAX_NUMBER_OF_VOXELS is a safety cap far above real scan
            # occupancy (KITTI test: cap 40k, real scans ~16-18k voxels at
            # 0.05m), this key bounds the buffer to the real workload.  The
            # device voxelizer compacts valid voxels to the front and
            # truncates overflow in hash order — semantics are IDENTICAL to
            # setting MAX_NUMBER_OF_VOXELS to the same value, so the cap is
            # lossless whenever real voxel counts stay under it (bench.py
            # measures and reports the real max).
            if 'VOXEL_BUFFER_CAP' in config:
                cap = config.VOXEL_BUFFER_CAP
                cap = int(cap[self.mode]) if isinstance(cap, dict) else int(cap)
                max_voxels = min(max_voxels, cap)
            self.voxel_cfg = {
                'voxel_size': tuple(float(v) for v in config.VOXEL_SIZE),
                'max_points_per_voxel': int(config.MAX_POINTS_PER_VOXEL),
                'max_voxels': max_voxels,
            }
            if 'MAX_POINTS_PER_FRAME' in config:
                self.max_points_per_frame = int(config.MAX_POINTS_PER_FRAME[self.mode]) \
                    if isinstance(config.MAX_POINTS_PER_FRAME, dict) \
                    else int(config.MAX_POINTS_PER_FRAME)
            return partial(self.transform_points_to_voxels, config=config)
        return data_dict

    def transform_points_to_voxels_placeholder(self, data_dict=None,
                                               config=None):
        """Parity: ``data_processor.py:105-113`` — dynamic-VFE configs set
        only the grid geometry.  Our pipeline still voxelizes on device (the
        dynamic VFEs consume the uncapped ``point_slot``), so a minimal
        voxel_cfg is recorded with K=1 (the capped (V, K, C) buffer is unused
        by Dyn* VFEs)."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            self.grid_size = np.asarray(grid_size_from_range(
                self.point_cloud_range, self.voxel_size), np.int64)
            self.voxel_cfg = {
                'voxel_size': tuple(float(v) for v in config.VOXEL_SIZE),
                'max_points_per_voxel': 1,
                'max_voxels': int(config.get('MAX_NUMBER_OF_VOXELS', {
                    'train': 40000, 'test': 40000})[self.mode]) if
                'MAX_NUMBER_OF_VOXELS' in config else 40000,
            }
            return partial(self.transform_points_to_voxels_placeholder,
                           config=config)
        return data_dict

    def calculate_grid_size(self, data_dict=None, config=None):
        """Parity: ``data_processor.py:177-183`` — set grid geometry without
        voxelizing (camera-only models, CaDDN)."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) \
                / self.voxel_size
            self.grid_size = np.round(grid).astype(np.int64)
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def downsample_depth_map(self, data_dict=None, config=None):
        """Parity: ``data_processor.py:185-194`` — local-mean downscale of
        the depth map (skimage ``downscale_local_mean`` equivalent)."""
        if data_dict is None:
            self.depth_downsample_factor = int(config.DOWNSAMPLE_FACTOR)
            return partial(self.downsample_depth_map, config=config)
        d = np.asarray(data_dict['depth_maps'], np.float32)
        f = self.depth_downsample_factor
        ph = (-d.shape[0]) % f
        pw = (-d.shape[1]) % f
        if ph or pw:   # downscale_local_mean zero-pads partial blocks
            d = np.pad(d, ((0, ph), (0, pw)))
        data_dict['depth_maps'] = d.reshape(
            d.shape[0] // f, f, d.shape[1] // f, f).mean(axis=(1, 3))
        return data_dict

    def pad_points_to_fixed(self, data_dict):
        """Pad/truncate points to (max_points_per_frame, C) + num_points."""
        points = data_dict['points']
        cap = self.max_points_per_frame
        n = min(len(points), cap)
        out = np.zeros((cap, points.shape[1]), np.float32)
        out[:n] = points[:n]
        data_dict['points'] = out
        data_dict['num_points'] = np.int32(n)
        return data_dict

    def forward(self, data_dict):
        for processor in self.data_processor_queue:
            data_dict = processor(data_dict=data_dict)
        if data_dict.get('points', None) is not None:
            data_dict = self.pad_points_to_fixed(data_dict)
        return data_dict
