"""Config-driven augmentation queue.

Parity: ``pcdet/datasets/augmentor/data_augmentor.py:9-120`` (dispatch by
NAME with DISABLE_AUG_LIST, gt_sampling via DataBaseSampler, world
flip/rotation/scaling)."""

from __future__ import annotations

from functools import partial

from . import augmentor_utils
from .database_sampler import DataBaseSampler


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_config_list = augmentor_configs if isinstance(augmentor_configs, list) \
            else augmentor_configs.AUG_CONFIG_LIST
        for cur_cfg in aug_config_list:
            if not isinstance(augmentor_configs, list):
                if cur_cfg.NAME in augmentor_configs.DISABLE_AUG_LIST:
                    continue
            self.data_augmentor_queue.append(
                getattr(self, cur_cfg.NAME)(config=cur_cfg))

    def gt_sampling(self, config=None):
        return DataBaseSampler(
            root_path=self.root_path, sampler_cfg=config,
            class_names=self.class_names, logger=self.logger)

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        for cur_axis in config['ALONG_AXIS_LIST']:
            assert cur_axis in ('x', 'y')
            gt_boxes, points = getattr(
                augmentor_utils, f'random_flip_along_{cur_axis}')(gt_boxes, points)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config['WORLD_ROT_ANGLE']
        if not isinstance(rot_range, list):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = augmentor_utils.global_rotation(
            data_dict['gt_boxes'], data_dict['points'], rot_range)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points = augmentor_utils.global_scaling(
            data_dict['gt_boxes'], data_dict['points'],
            config['WORLD_SCALE_RANGE'])
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        gt_boxes, points = augmentor_utils.random_world_translation(
            data_dict['gt_boxes'], data_dict['points'],
            config['NOISE_TRANSLATE_STD'])
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_local_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_translation, config=config)
        gt_boxes, points = augmentor_utils.random_local_translation(
            data_dict['gt_boxes'], data_dict['points'],
            config['LOCAL_TRANSLATION_RANGE'],
            axes=tuple(config.get('ALONG_AXIS_LIST', ['x', 'y', 'z'])))
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_local_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_rotation, config=config)
        rot_range = config['LOCAL_ROT_ANGLE']
        if not isinstance(rot_range, list):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = augmentor_utils.local_rotation(
            data_dict['gt_boxes'], data_dict['points'], rot_range)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_local_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_scaling, config=config)
        gt_boxes, points = augmentor_utils.local_scaling(
            data_dict['gt_boxes'], data_dict['points'],
            config['LOCAL_SCALE_RANGE'])
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_world_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_frustum_dropout, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        for direction in config['DIRECTION']:
            gt_boxes, points = augmentor_utils.global_frustum_dropout(
                gt_boxes, points, config['INTENSITY_RANGE'], direction)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_local_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_frustum_dropout, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        for direction in config['DIRECTION']:
            gt_boxes, points = augmentor_utils.local_frustum_dropout(
                gt_boxes, points, config['INTENSITY_RANGE'], direction)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_local_pyramid_aug(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_pyramid_aug, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        gt_boxes, points = augmentor_utils.local_pyramid_dropout(
            gt_boxes, points, config['DROP_PROB'])
        gt_boxes, points = augmentor_utils.local_pyramid_sparsify(
            gt_boxes, points, config['SPARSIFY_PROB'],
            config['SPARSIFY_MAX_NUM'])
        gt_boxes, points = augmentor_utils.local_pyramid_swap(
            gt_boxes, points, config['SWAP_PROB'], config['SWAP_MAX_NUM'])
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_image_flip(self, data_dict=None, config=None):
        """Horizontal image flip + matching camera-frame box flip (parity:
        data_augmentor.py:82-99).  Depth-map models (CaDDN) carry 'images'
        and 'depth_maps'; the lidar path is unaffected."""
        if data_dict is None:
            return partial(self.random_image_flip, config=config)
        import numpy as np
        enable = np.random.choice([False, True], p=[0.5, 0.5])
        if enable and 'images' in data_dict:
            data_dict['images'] = data_dict['images'][:, ::-1].copy()
            if 'depth_maps' in data_dict:
                data_dict['depth_maps'] = \
                    data_dict['depth_maps'][:, ::-1].copy()
            # camera-frame boxes mirror in x; lidar boxes mirror in y
            gt = data_dict['gt_boxes'].copy()
            gt[:, 1] = -gt[:, 1]
            gt[:, 6] = -gt[:, 6]
            data_dict['gt_boxes'] = gt
        return data_dict

    def forward(self, data_dict):
        for augmentor in self.data_augmentor_queue:
            data_dict = augmentor(data_dict=data_dict)
        # filter non-class gts and drop the mask (parity:
        # data_augmentor.py:250-257; gt_sampling already consumed it if run)
        if 'gt_boxes_mask' in data_dict:
            mask = data_dict['gt_boxes_mask']
            data_dict['gt_boxes'] = data_dict['gt_boxes'][mask]
            data_dict['gt_names'] = data_dict['gt_names'][mask]
            if 'gt_boxes2d' in data_dict:
                data_dict['gt_boxes2d'] = data_dict['gt_boxes2d'][mask]
            data_dict.pop('gt_boxes_mask')
        return data_dict
