"""KITTI dataset: info-pkl driven loading, FOV filtering, info/gt-database
generation, KITTI-format prediction export, official evaluation.

Copy of ``crb_active_3ddet_tpu/datasets/kitti/kitti_dataset.py`` (parity:
``pcdet/datasets/kitti/kitti_dataset.py`` __getitem__ :371-429, get_infos
:150-222, create_groundtruth_database :224-274, generate_prediction_dicts
:276-351, evaluation :353-363, create_kitti_infos :432-469).  Fixed-shape
delta: predictions arrive as padded (B, P, ...) arrays + validity mask
instead of ragged tensors.  The host code stays numpy.

Two deltas from the JAX module:
- ``get_image_shape`` reads the PNG's height and width from its IHDR chunk
  (bytes 16-24, big-endian) with the standard library, so the info builder
  needs no PIL; it equals PIL's ``Image.open(...).size[::-1]``.
- ``get_image`` and ``get_depth_map`` keep PIL as an import inside the
  function: they serve ``GET_ITEM_LIST`` images only (camera models), which
  no path of the port reads yet.

    python -m crb_active_3ddet_torch.datasets.kitti.kitti_dataset \
        create_kitti_infos <dataset_cfg.yaml> [data_path]
"""

from __future__ import annotations

import pickle
import struct

import numpy as np

from ...utils import box_utils
from ..dataset import DatasetTemplate
from . import calibration_kitti, object3d_kitti


_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def png_shape(path):
    """(height, width) int32 of a PNG file, read from its IHDR chunk."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b'IHDR':
        raise ValueError(f'{path}: not a PNG file')
    width, height = struct.unpack('>II', head[16:24])
    return np.array([height, width], dtype=np.int32)


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.root_split_path = self.root_path / (
            'training' if self.split != 'test' else 'testing')
        split_file = self.root_path / 'ImageSets' / f'{self.split}.txt'
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else None
        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        if self.logger is not None:
            self.logger.info('Loading KITTI dataset')
        kitti_infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, 'rb') as f:
                kitti_infos.extend(pickle.load(f))
        self.kitti_infos.extend(kitti_infos)
        if self.logger is not None:
            self.logger.info('Total samples for KITTI dataset: %d',
                             len(kitti_infos))

    def set_split(self, split):
        self.__init__(self.dataset_cfg, self.class_names,
                      training=self.training, root_path=self.root_path,
                      logger=self.logger)
        self.split = split
        self.root_split_path = self.root_path / (
            'training' if self.split != 'test' else 'testing')
        split_file = self.root_path / 'ImageSets' / f'{split}.txt'
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else None

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / 'velodyne' / f'{idx}.bin'
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)

    def get_image_shape(self, idx):
        """(height, width) int32 of ``image_2/<idx>.png``, from its header."""
        img_file = self.root_split_path / 'image_2' / f'{idx}.png'
        return png_shape(img_file)

    def get_image(self, idx):
        """(H, W, 3) float32 RGB in [0, 1] (parity :68-80)."""
        from PIL import Image
        img_file = self.root_split_path / 'image_2' / f'{idx}.png'
        return np.asarray(Image.open(img_file), np.float32) / 255.0

    def get_depth_map(self, idx):
        """(H, W) float32 depth in meters (parity :93-106, uint16/256)."""
        from PIL import Image
        depth_file = self.root_split_path / 'depth_2' / f'{idx}.png'
        return np.asarray(Image.open(depth_file), np.float32) / 256.0

    def get_label(self, idx):
        label_file = self.root_split_path / 'label_2' / f'{idx}.txt'
        return object3d_kitti.get_objects_from_label(label_file)

    def get_calib(self, idx):
        calib_file = self.root_split_path / 'calib' / f'{idx}.txt'
        return calibration_kitti.Calibration(calib_file)

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / 'planes' / f'{idx}.txt'
        if not plane_file.exists():
            return None
        with open(plane_file, 'r') as f:
            lines = f.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val_flag_1 = np.logical_and(pts_img[:, 0] >= 0, pts_img[:, 0] < img_shape[1])
        val_flag_2 = np.logical_and(pts_img[:, 1] >= 0, pts_img[:, 1] < img_shape[0])
        val_flag_merge = np.logical_and(val_flag_1, val_flag_2)
        return np.logical_and(val_flag_merge, pts_rect_depth >= 0)

    # ---- info generation (the on-disk pkl layout is fixed by the
    # ecosystem: every field below is read back by the eval/gt-db/AL code,
    # so names and dtypes must match the reference's info files bit-for-bit;
    # the construction itself is this repo's own) ----
    _OBJ_FIELDS = {
        'name': ('cls_type', None),
        'truncated': ('truncation', None),
        'occluded': ('occlusion', None),
        'alpha': ('alpha', None),
        'rotation_y': ('ry', None),
        'score': ('score', None),
        'difficulty': ('level', np.int32),
    }

    def _calib_block(self, calib):
        """4x4-homogenized calib matrices (info['calib'] layout)."""
        pad_row = np.array([[0., 0., 0., 1.]])
        r0 = np.zeros((4, 4), dtype=calib.R0.dtype)
        r0[:3, :3], r0[3, 3] = calib.R0, 1.0
        return {'P2': np.concatenate([calib.P2, pad_row], axis=0),
                'R0_rect': r0,
                'Tr_velo_to_cam': np.concatenate([calib.V2C, pad_row],
                                                 axis=0)}

    def _annotations_block(self, objs, calib):
        """KITTI label objects → the annos dict incl. lidar-frame boxes."""
        annos = {key: np.array([getattr(o, attr) for o in objs],
                               dtype=dt) if dt else
                 np.array([getattr(o, attr) for o in objs])
                 for key, (attr, dt) in self._OBJ_FIELDS.items()}
        annos['bbox'] = (np.stack([o.box2d for o in objs])
                         if objs else np.zeros((0, 4)))
        annos['dimensions'] = np.array(
            [[o.l, o.h, o.w] for o in objs]).reshape(-1, 3)
        annos['location'] = (np.stack([o.loc for o in objs])
                             if objs else np.zeros((0, 3)))
        n_fg = sum(o.cls_type != 'DontCare' for o in objs)
        n_all = len(objs)
        annos['index'] = np.array(
            list(range(n_fg)) + [-1] * (n_all - n_fg), np.int32)

        # camera-frame fg boxes → lidar frame (bottom-center → centroid)
        loc_lidar = calib.rect_to_lidar(annos['location'][:n_fg])
        dims = annos['dimensions'][:n_fg]            # l, h, w (camera order)
        loc_lidar[:, 2] += dims[:, 1] / 2
        heading = -(np.pi / 2 + annos['rotation_y'][:n_fg, None])
        annos['gt_boxes_lidar'] = np.concatenate(
            [loc_lidar, dims[:, [0]], dims[:, [2]], dims[:, [1]], heading],
            axis=1)
        return annos, n_fg

    def _count_points_in_gt(self, sample_idx, info, annos, n_fg):
        from ...ops.points_in_boxes import points_in_boxes_numpy
        calib = self.get_calib(sample_idx)
        points = self.get_lidar(sample_idx)
        fov = self.get_fov_flag(calib.lidar_to_rect(points[:, 0:3]),
                                info['image']['image_shape'], calib)
        counts = np.full(len(annos['name']), -1, np.int32)
        if n_fg > 0:
            member = points_in_boxes_numpy(points[fov][:, :3],
                                           annos['gt_boxes_lidar'])
            counts[:n_fg] = member.sum(axis=0)
        annos['num_points_in_gt'] = counts

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        """Per-frame info dicts (parity: kitti_dataset.get_infos :150-222 —
        identical pkl schema, restructured construction)."""
        import concurrent.futures as futures

        def one(sample_idx):
            calib = self.get_calib(sample_idx)
            info = {
                'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx},
                'image': {'image_idx': sample_idx,
                          'image_shape': self.get_image_shape(sample_idx)},
                'calib': self._calib_block(calib),
            }
            if has_label:
                annos, n_fg = self._annotations_block(
                    self.get_label(sample_idx), calib)
                if count_inside_pts:
                    self._count_points_in_gt(sample_idx, info, annos, n_fg)
                info['annos'] = annos
            return info

        sample_id_list = sample_id_list or self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as executor:
            return list(executor.map(one, sample_id_list))

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        """Parity: :224-274 — crop per-gt point clouds into a pickle-indexed
        file database for gt-sampling augmentation."""
        database_save_path = self.root_path / (
            f'gt_database' if split == 'train' else f'gt_database_{split}')
        db_info_save_path = self.root_path / f'kitti_dbinfos_{split}.pkl'
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)

        from ...ops.points_in_boxes import points_in_boxes_numpy
        for k, info in enumerate(infos):
            sample_idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar(sample_idx)
            annos = info['annos']
            names = annos['name']
            difficulty = annos['difficulty']
            gt_boxes = annos['gt_boxes_lidar']
            num_obj = gt_boxes.shape[0]
            if num_obj == 0:
                continue
            member = points_in_boxes_numpy(points[:, :3], gt_boxes)
            for i in range(num_obj):
                filename = f'{sample_idx}_{names[i]}_{i}.bin'
                filepath = database_save_path / filename
                gt_points = points[member[:, i]]
                gt_points[:, :3] -= gt_boxes[i, :3]
                with open(filepath, 'w') as f:
                    gt_points.tofile(f)
                if used_classes is None or names[i] in used_classes:
                    db_path = str(filepath.relative_to(self.root_path))
                    db_info = {'name': names[i], 'path': db_path,
                               'image_idx': sample_idx, 'gt_idx': i,
                               'box3d_lidar': gt_boxes[i],
                               'num_points_in_gt': gt_points.shape[0],
                               'difficulty': difficulty[i],
                               'bbox': annos['bbox'][i],
                               'score': annos['score'][i]}
                    all_db_infos.setdefault(names[i], []).append(db_info)
        for key, val in all_db_infos.items():
            print(f'Database {key}: {len(val)}')
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Fixed-shape (B, P, ...) preds → KITTI camera-frame annos.
        Parity: :276-351."""
        annos = []
        for index in range(batch_dict['batch_size']):
            valid = np.asarray(pred_dicts['pred_valid'][index])
            boxes_lidar = np.asarray(pred_dicts['pred_boxes'][index])[valid]
            scores = np.asarray(pred_dicts['pred_scores'][index])[valid]
            labels = np.asarray(pred_dicts['pred_labels'][index])[valid]
            frame_id = batch_dict['frame_id'][index]
            calib = batch_dict['calib'][index]
            image_shape = np.asarray(batch_dict['image_shape'][index])

            num = len(boxes_lidar)
            anno = {
                'name': np.array([class_names[l - 1] for l in labels]),
                'truncated': np.zeros(num), 'occluded': np.zeros(num),
                'score': scores, 'boxes_lidar': boxes_lidar,
                'frame_id': frame_id, 'pred_labels': labels,
            }
            if num == 0:
                anno.update({'alpha': np.zeros(0), 'bbox': np.zeros([0, 4]),
                             'dimensions': np.zeros([0, 3]),
                             'location': np.zeros([0, 3]),
                             'rotation_y': np.zeros(0)})
                annos.append(anno)
                continue
            boxes_camera = box_utils.boxes3d_lidar_to_kitti_camera(
                boxes_lidar, calib)
            boxes_img = box_utils.boxes3d_kitti_camera_to_imageboxes(
                boxes_camera, calib, image_shape=image_shape)
            anno.update({
                'alpha': -np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0])
                         + boxes_camera[:, 6],
                'bbox': boxes_img,
                'dimensions': boxes_camera[:, 3:6],
                'location': boxes_camera[:, 0:3],
                'rotation_y': boxes_camera[:, 6],
            })
            annos.append(anno)
            if output_path is not None:
                cur_det_file = output_path / f'{frame_id}.txt'
                with open(cur_det_file, 'w') as f:
                    bbox, loc, dims = anno['bbox'], anno['location'], anno['dimensions']
                    for idx in range(num):
                        print('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                              '%.4f %.4f %.4f %.4f %.4f'
                              % (anno['name'][idx], anno['alpha'][idx],
                                 bbox[idx][0], bbox[idx][1], bbox[idx][2],
                                 bbox[idx][3], dims[idx][1], dims[idx][2],
                                 dims[idx][0], loc[idx][0], loc[idx][1],
                                 loc[idx][2], anno['rotation_y'][idx],
                                 anno['score'][idx]), file=f)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        if 'annos' not in self.kitti_infos[0]:
            return None, {}
        from .kitti_eval import eval as kitti_eval
        import copy
        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        ap_result_str, ap_dict = kitti_eval.get_official_eval_result(
            eval_gt_annos, eval_det_annos, class_names)
        return ap_result_str, ap_dict

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.kitti_infos) * self.total_epochs
        return len(self.kitti_infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        info = self.kitti_infos[index]
        sample_idx = info['point_cloud']['lidar_idx']
        img_shape = info['image']['image_shape']
        calib = self.get_calib(sample_idx)
        get_item_list = self.dataset_cfg.get('GET_ITEM_LIST', ['points'])

        input_dict = {'frame_id': sample_idx, 'calib': calib,
                      'image_shape': img_shape}
        if 'annos' in info:
            annos = info['annos']
            mask = annos['name'] != 'DontCare'
            loc = annos['location'][mask]
            dims = annos['dimensions'][mask]
            rots = annos['rotation_y'][mask]
            gt_names = annos['name'][mask]
            gt_boxes_camera = np.concatenate(
                [loc, dims, rots[..., np.newaxis]], axis=1).astype(np.float32)
            gt_boxes_lidar = box_utils.boxes3d_kitti_camera_to_lidar(
                gt_boxes_camera, calib)
            input_dict.update({'gt_names': gt_names,
                               'gt_boxes': gt_boxes_lidar})
            if 'gt_boxes2d' in get_item_list:
                input_dict['gt_boxes2d'] = annos['bbox'][mask]
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict['road_plane'] = road_plane

        if 'points' in get_item_list:
            points = self.get_lidar(sample_idx)
            if self.dataset_cfg.FOV_POINTS_ONLY:
                pts_rect = calib.lidar_to_rect(points[:, 0:3])
                fov_flag = self.get_fov_flag(pts_rect, img_shape, calib)
                points = points[fov_flag]
            input_dict['points'] = points

        if 'images' in get_item_list:
            input_dict['images'] = self.get_image(sample_idx)
        if 'depth_maps' in get_item_list:
            input_dict['depth_maps'] = self.get_depth_map(sample_idx)
        if 'calib_matricies' in get_item_list:
            # kitti_utils.calib_to_matricies (:52-66): V2R = R0_4x4 @ V2C_4x4
            v2c = np.vstack([calib.V2C, [0, 0, 0, 1]]).astype(np.float32)
            r0 = np.eye(4, dtype=np.float32)
            r0[:3, :3] = calib.R0
            input_dict['trans_lidar_to_cam'] = r0 @ v2c
            input_dict['trans_cam_to_img'] = calib.P2.astype(np.float32)

        data_dict = self.prepare_data(data_dict=input_dict)
        data_dict['image_shape'] = img_shape
        return data_dict


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path,
                       workers=4):
    """CLI: build kitti_infos pkls + gt database (parity :432-469)."""
    dataset = KittiDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False)
    train_split, val_split = 'train', 'val'
    train_filename = save_path / f'kitti_infos_{train_split}.pkl'
    val_filename = save_path / f'kitti_infos_{val_split}.pkl'

    print('---------------Start to generate data infos---------------')
    dataset.set_split(train_split)
    kitti_infos_train = dataset.get_infos(
        num_workers=workers, has_label=True, count_inside_pts=True)
    with open(train_filename, 'wb') as f:
        pickle.dump(kitti_infos_train, f)
    print(f'Kitti info train file is saved to {train_filename}')

    dataset.set_split(val_split)
    kitti_infos_val = dataset.get_infos(
        num_workers=workers, has_label=True, count_inside_pts=True)
    with open(val_filename, 'wb') as f:
        pickle.dump(kitti_infos_val, f)
    print(f'Kitti info val file is saved to {val_filename}')

    with open(save_path / 'kitti_infos_trainval.pkl', 'wb') as f:
        pickle.dump(kitti_infos_train + kitti_infos_val, f)

    print('---------------Start create groundtruth database for data augmentation---------------')
    dataset.set_split(train_split)
    dataset.create_groundtruth_database(train_filename, split=train_split)
    print('---------------Data preparation Done---------------')


if __name__ == '__main__':
    # (parity: pcdet/datasets/kitti/kitti_dataset.py:471-484)
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == 'create_kitti_infos':
        from pathlib import Path
        import yaml
        from ...config import CfgNode
        dataset_cfg = CfgNode(yaml.safe_load(open(sys.argv[2])))
        data_path = Path(sys.argv[3]) if len(sys.argv) > 3 \
            else Path(dataset_cfg.DATA_PATH)
        create_kitti_infos(
            dataset_cfg=dataset_cfg,
            class_names=['Car', 'Pedestrian', 'Cyclist'],
            data_path=data_path, save_path=data_path)
