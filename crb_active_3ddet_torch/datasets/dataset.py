"""Dataset template: augment → encode → process pipeline + fixed-shape collate.

Parity: ``pcdet/datasets/dataset.py`` (prepare_data :102-158,
collate_batch :160-229).

TPU-first deltas:
  - every per-sample output is fixed-shape: points padded to
    MAX_POINTS_PER_FRAME (+ num_points), gt_boxes padded to MAX_GT_BOXES —
    the reference pads gt to max-in-batch (dynamic) and stacks ragged
    points with batch-idx prefixes, which would retrigger XLA compilation
    every step.
  - voxelization moved on-device (see processor/data_processor.py).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch.utils.data as torch_data

from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder

MAX_GT_BOXES = 64  # static gt pad (KITTI scenes have <35 after gt-sampling)


class DatasetTemplate(torch_data.Dataset):
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        super().__init__()
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(root_path) if root_path is not None else \
            Path(dataset_cfg.DATA_PATH) if dataset_cfg is not None else None
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(
            self.dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range)
        self.data_augmentor = DataAugmentor(
            self.root_path, self.dataset_cfg.DATA_AUGMENTOR, self.class_names,
            logger=self.logger) if self.training else None
        self.data_processor = DataProcessor(
            self.dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range, training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features)

        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.voxel_cfg = self.data_processor.voxel_cfg
        self.depth_downsample_factor = getattr(
            self.data_processor, 'depth_downsample_factor', None)
        # fixed-shape image buffer (reference pads per-batch to the max size
        # in collate_batch, dataset.py:193-220; TPU needs one static shape)
        self.image_pad_shape = tuple(
            self.dataset_cfg.get('IMAGE_PAD_SHAPE', (384, 1248)))
        self.max_gt_boxes = int(self.dataset_cfg.get('MAX_GT_BOXES', MAX_GT_BOXES))
        self.total_epochs = 0
        self._merge_all_iters_to_one_epoch = False

    @property
    def num_point_features(self):
        return self.point_feature_encoder.num_point_features

    @property
    def mode(self):
        return 'train' if self.training else 'test'

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop('logger', None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.logger = None

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs if merge else 0

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """Parity: ``dataset.py:102-158`` + fixed-shape gt padding."""
        if self.training:
            assert 'gt_boxes' in data_dict, 'gt_boxes required for training'
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict['gt_names']], np.bool_)
            data_dict = self.data_augmentor.forward(
                data_dict={**data_dict, 'gt_boxes_mask': gt_boxes_mask})

        if data_dict.get('gt_boxes', None) is not None:
            selected = [i for i, n in enumerate(data_dict['gt_names'])
                        if n in self.class_names]
            selected = np.array(selected, np.int64)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][selected]
            data_dict['gt_names'] = data_dict['gt_names'][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict['gt_names']],
                np.int32)
            data_dict['gt_boxes'] = np.concatenate(
                [data_dict['gt_boxes'],
                 gt_classes.reshape(-1, 1).astype(np.float32)], axis=1)

        if data_dict.get('points', None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)

        data_dict = self.data_processor.forward(data_dict=data_dict)

        if self.training and len(data_dict['gt_boxes']) == 0:
            new_index = np.random.randint(self.__len__())
            return self.__getitem__(new_index)

        # fixed-shape gt padding (zero rows = padding, like the reference)
        if data_dict.get('gt_boxes', None) is not None:
            gt = data_dict['gt_boxes'][:self.max_gt_boxes]
            out = np.zeros((self.max_gt_boxes, gt.shape[1]), np.float32)
            out[:len(gt)] = gt
            data_dict['gt_boxes'] = out
        if data_dict.get('gt_boxes2d', None) is not None:
            b2 = np.asarray(data_dict['gt_boxes2d'],
                            np.float32)[:self.max_gt_boxes]
            out2 = np.zeros((self.max_gt_boxes, 4), np.float32)
            out2[:len(b2)] = b2
            data_dict['gt_boxes2d'] = out2

        # fixed-shape NaN padding for camera inputs (collate parity above)
        if data_dict.get('images', None) is not None:
            ph, pw = self.image_pad_shape
            img = np.asarray(data_dict['images'], np.float32)[:ph, :pw]
            out_img = np.full((ph, pw, img.shape[2]), np.nan, np.float32)
            out_img[:img.shape[0], :img.shape[1]] = img
            data_dict['images'] = out_img
        if data_dict.get('depth_maps', None) is not None:
            f = self.depth_downsample_factor or 1
            ph, pw = -(-self.image_pad_shape[0] // f), \
                -(-self.image_pad_shape[1] // f)
            dm = np.asarray(data_dict['depth_maps'], np.float32)[:ph, :pw]
            out_dm = np.full((ph, pw), np.nan, np.float32)
            out_dm[:dm.shape[0], :dm.shape[1]] = dm
            data_dict['depth_maps'] = out_dm

        data_dict.pop('gt_names', None)
        return data_dict

    @staticmethod
    def collate_batch(batch_list, _unused=False):
        """Fixed-shape collation: everything numeric is plain np.stack (all
        per-sample arrays are already padded), strings/objects become lists.
        Parity surface: ``dataset.py:160-229``."""
        data_dict = defaultdict(list)
        for cur_sample in batch_list:
            for key, val in cur_sample.items():
                data_dict[key].append(val)
        ret = {}
        for key, val in data_dict.items():
            if isinstance(val[0], np.ndarray) or np.isscalar(val[0]) \
                    or isinstance(val[0], (np.integer, np.floating)):
                ret[key] = np.stack([np.asarray(v) for v in val], axis=0)
            else:
                ret[key] = val  # frame_id strings, calib objects, metadata
        ret['batch_size'] = len(batch_list)
        return ret

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        raise NotImplementedError
