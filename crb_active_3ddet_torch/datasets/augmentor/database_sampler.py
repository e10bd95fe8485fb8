"""GT-database sampling ("copy-paste" augmentation).

Parity: ``pcdet/datasets/augmentor/database_sampler.py`` —
``__call__`` :191 (sample groups per class, BEV-overlap rejection against
existing + already-sampled boxes via the rotated-IoU kernel),
``add_sampled_boxes_to_scene`` :150 (load point crops, translate to box
position, remove occluded background points), filters by difficulty /
min-points (:57-78), optional road-plane z alignment (:131-149).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...ops.points_in_boxes import points_in_boxes_numpy
from ...utils import box_utils


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.logger = logger
        self.db_infos = {name: [] for name in class_names}
        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = self.root_path / db_info_path
            with open(path, 'rb') as f:
                infos = pickle.load(f)
                for name in class_names:
                    if name in infos:
                        self.db_infos[name].extend(infos[name])

        for func_name, val in sampler_cfg.PREPARE.items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.use_road_plane = sampler_cfg.get('USE_ROAD_PLANE', False)
        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(':')
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = sample_num
            self.sample_groups[class_name] = {
                'sample_num': sample_num,
                'pointer': len(self.db_infos[class_name]),
                'indices': np.arange(len(self.db_infos[class_name])),
            }

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new_db_infos = {}
        for key, dinfos in db_infos.items():
            new_db_infos[key] = [
                info for info in dinfos
                if info['difficulty'] not in removed_difficulty
            ]
        return new_db_infos

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(':')
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info for info in db_infos[name]
                    if info['num_points_in_gt'] >= min_num
                ]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group):
        """Shuffled round-robin sampling (parity :100-115)."""
        sample_num = int(sample_group['sample_num'])
        pointer, indices = sample_group['pointer'], sample_group['indices']
        total = len(self.db_infos[class_name])
        if total == 0:
            return []
        if pointer >= total:
            indices = np.random.permutation(total)
            pointer = 0
        sampled = [self.db_infos[class_name][idx]
                   for idx in indices[pointer:pointer + sample_num]]
        sample_group['pointer'] = pointer + sample_num
        sample_group['indices'] = indices
        return sampled

    def put_boxes_on_road_planes(self, gt_boxes, road_planes, calib):
        """Parity :131-149 — align sampled box bottoms to the road plane."""
        a, b, c, d = road_planes
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = cur_height_cam
        cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes,
                                   total_valid_sampled_dict):
        gt_boxes_mask = data_dict['gt_boxes_mask']
        gt_boxes = data_dict['gt_boxes'][gt_boxes_mask]
        gt_names = data_dict['gt_names'][gt_boxes_mask]
        points = data_dict['points']

        if self.use_road_plane and 'road_plane' in data_dict:
            sampled_gt_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_gt_boxes, data_dict['road_plane'], data_dict['calib'])
        else:
            mv_height = None

        obj_points_list = []
        for idx, info in enumerate(total_valid_sampled_dict):
            file_path = self.root_path / info['path']
            obj_points = np.fromfile(str(file_path), dtype=np.float32).reshape(
                [-1, self.sampler_cfg.NUM_POINT_FEATURES])
            obj_points[:, :3] += info['box3d_lidar'][:3]
            if mv_height is not None:
                obj_points[:, 2] -= mv_height[idx]
            obj_points_list.append(obj_points)

        obj_points = np.concatenate(obj_points_list, axis=0) if obj_points_list \
            else np.zeros((0, points.shape[1]), np.float32)
        sampled_gt_names = np.array([x['name'] for x in total_valid_sampled_dict])

        extra_width = self.sampler_cfg.get('REMOVE_EXTRA_WIDTH', [0, 0, 0])
        large_boxes = box_utils.enlarge_box3d(sampled_gt_boxes, extra_width)
        points = box_utils.remove_points_in_boxes3d(points, large_boxes)
        points = np.concatenate([obj_points[:, :points.shape[1]], points], axis=0)
        gt_names = np.concatenate([gt_names, sampled_gt_names], axis=0)
        gt_boxes = np.concatenate([gt_boxes, sampled_gt_boxes[:, :gt_boxes.shape[1]]], axis=0)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['gt_names'] = gt_names
        data_dict['points'] = points
        return data_dict

    def __call__(self, data_dict):
        gt_boxes = data_dict['gt_boxes']
        gt_names = data_dict['gt_names'].astype(str)
        existed_boxes = gt_boxes
        total_valid_sampled_dict = []
        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = np.sum(class_name == gt_names)
                sample_group['sample_num'] = str(
                    int(self.sample_class_num[class_name]) - num_gt)
            if int(sample_group['sample_num']) > 0:
                sampled_dict = self.sample_with_fixed_number(class_name, sample_group)
                if not sampled_dict:
                    continue
                sampled_boxes = np.stack(
                    [x['box3d_lidar'] for x in sampled_dict], axis=0).astype(np.float32)

                # rejection: sampled boxes must not BEV-overlap existing boxes
                # or each other (reference uses iou3d_nms BEV IoU :214-221)
                iou1 = _bev_iou_numpy(sampled_boxes[:, 0:7], existed_boxes[:, 0:7])
                iou2 = _bev_iou_numpy(sampled_boxes[:, 0:7], sampled_boxes[:, 0:7])
                iou2[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
                iou1 = iou1 if iou1.shape[1] > 0 else iou2
                valid_mask = ((iou1.max(axis=1) + iou2.max(axis=1)) == 0).nonzero()[0]
                valid_sampled_dict = [sampled_dict[x] for x in valid_mask]
                valid_sampled_boxes = sampled_boxes[valid_mask]

                existed_boxes = np.concatenate(
                    [existed_boxes, valid_sampled_boxes[:, :existed_boxes.shape[1]]], axis=0)
                total_valid_sampled_dict.extend(valid_sampled_dict)

        sampled_gt_boxes = existed_boxes[gt_boxes.shape[0]:, :]
        if total_valid_sampled_dict:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_gt_boxes, total_valid_sampled_dict)
        data_dict.pop('gt_boxes_mask')
        return data_dict


def _bev_iou_numpy(boxes_a, boxes_b):
    """Boolean rotated-BEV overlap matrix as float (0/1) via the separating
    axis theorem — pure numpy so dataloader workers never touch JAX.  The
    sampler only tests ``iou == 0`` (any-overlap rejection), so a boolean
    overlap is equivalent to the reference's exact IoU here."""
    if boxes_a.shape[0] == 0 or boxes_b.shape[0] == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]), np.float32)
    ca = box_utils.corners_bev(boxes_a)  # (N, 4, 2)
    cb = box_utils.corners_bev(boxes_b)  # (M, 4, 2)

    def axes(boxes):
        h = boxes[:, 6]
        c, s = np.cos(h), np.sin(h)
        return np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)  # (N, 2, 2)

    overlap = np.ones((boxes_a.shape[0], boxes_b.shape[0]), bool)
    for source, corners_self, corners_other in (
            (axes(boxes_a), ca, cb), (axes(boxes_b), cb, ca)):
        for k in range(2):
            ax = source[:, k]  # per-box axis (n, 2)
            if corners_self is ca:
                pa = np.einsum('nij,nj->ni', ca, ax)            # (N, 4)
                pb = np.einsum('mij,nj->nmi', cb, ax)           # (N, M, 4)
                sep = (pa.max(1)[:, None] < pb.min(2)) | (pb.max(2) < pa.min(1)[:, None])
            else:
                pb_self = np.einsum('mij,mj->mi', cb, ax)       # (M, 4)
                pa_other = np.einsum('nij,mj->mni', ca, ax)     # (M, N, 4)
                sep = ((pb_self.max(1)[:, None] < pa_other.min(2))
                       | (pa_other.max(2) < pb_self.min(1)[:, None])).T
            overlap &= ~sep
    return overlap.astype(np.float32)
