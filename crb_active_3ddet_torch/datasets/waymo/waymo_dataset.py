"""Waymo Open Dataset: sequence-info driven loading, per-frame .npy points,
the gt database, KITTI-style or official evaluation, the preprocessing CLI.

Copy of ``crb_active_3ddet_tpu/datasets/waymo/waymo_dataset.py`` (parity:
``pcdet/datasets/waymo/waymo_dataset.py``: sequence infos :38-124, AL
identity by ``frame_ids`` + ``infos`` (not KITTI's ``sample_id_list``),
evaluation :273-325, the gt database :326-406, the CLI :408+).  The tfrecord
converter needs ``waymo-open-dataset`` (``waymo_utils._require_waymo``);
everything else works from the preprocessed ``.npy`` and info ``.pkl`` files,
whose layout is the reference's, so existing preprocessed data drops in.

One delta from the JAX module: ``__getitem__`` drops ``num_points_in_gt``
from the sample after ``prepare_data``, as OpenPCDet's ``__getitem__`` does.
The JAX module keeps it, so its collate stacks arrays of each frame's object
count, which raises for a batch whose frames hold different numbers of
objects.

    python -m crb_active_3ddet_torch.datasets.waymo.waymo_dataset \
        --cfg_file tools/cfgs/dataset_configs/waymo_dataset.yaml \
        [--func create_waymo_infos | create_groundtruth_database] \
        [--data_path data/waymo] [--processed_data_tag waymo_processed_data] \
        [--workers 4]

``create_waymo_infos`` converts the tfrecords under ``<data_path>/raw_data``
(it needs the packages above) and then builds the gt database;
``create_groundtruth_database`` builds it alone from
``<processed_data_tag>_infos_train.pkl`` and needs nothing beyond numpy.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
from functools import partial
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.data_path = self.root_path / \
            self.dataset_cfg.get('PROCESSED_DATA_TAG', 'waymo_processed_data')
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / 'ImageSets' / f'{self.split}.txt'
        self.sample_sequence_list = [
            x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []
        self.infos = []
        self.frame_ids = []
        self.include_waymo_data(self.mode)
        # shared-memory point cache (parity: waymo_dataset.py:38-41,81-124 —
        # the reference uses the SharedArray package; stdlib
        # multiprocessing.shared_memory gives the same /dev/shm semantics)
        self.use_shared_memory = (self.dataset_cfg.get('USE_SHARED_MEMORY',
                                                       False)
                                  and self.training)
        self._shm_handles = {}
        if self.use_shared_memory:
            self.shared_memory_file_limit = int(self.dataset_cfg.get(
                'SHARED_MEMORY_FILE_LIMIT', 0x7FFFFFFF))
            self.load_data_to_shared_memory()

    def set_split(self, split):
        self.split = split
        split_file = self.root_path / 'ImageSets' / f'{split}.txt'
        self.sample_sequence_list = [
            x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []
        self.infos = []
        self.frame_ids = []
        self.include_waymo_data(self.mode)

    # ---- shared-memory point cache -----------------------------------------
    @staticmethod
    def _sa_key(sequence_name, sample_idx):
        return f'{sequence_name}___{sample_idx}'

    def load_data_to_shared_memory(self):
        from multiprocessing import shared_memory
        infos = self.infos[:self.shared_memory_file_limit]
        for info in infos:
            pc = info['point_cloud']
            key = self._sa_key(pc['lidar_sequence'], pc['sample_idx'])
            if os.path.exists(f'/dev/shm/{key}'):
                continue
            points = self.get_lidar(pc['lidar_sequence'], pc['sample_idx'],
                                    from_shm=False)
            shm = shared_memory.SharedMemory(name=key, create=True,
                                             size=points.nbytes + 16)
            hdr = np.ndarray((2,), np.int64, buffer=shm.buf[:16])
            hdr[:] = points.shape
            dst = np.ndarray(points.shape, np.float32, buffer=shm.buf[16:])
            dst[:] = points
            shm.close()
        if self.logger is not None:
            self.logger.info('Waymo points cached to shared memory (%d)',
                             len(infos))

    def _get_lidar_shm(self, sequence_name, sample_idx):
        from multiprocessing import shared_memory
        key = self._sa_key(sequence_name, sample_idx)
        if not os.path.exists(f'/dev/shm/{key}'):
            return None
        if key not in self._shm_handles:
            self._shm_handles[key] = shared_memory.SharedMemory(name=key)
        shm = self._shm_handles[key]
        hdr = np.ndarray((2,), np.int64, buffer=shm.buf[:16])
        return np.ndarray((int(hdr[0]), int(hdr[1])), np.float32,
                          buffer=shm.buf[16:]).copy()

    def clean_shared_memory(self):
        from multiprocessing import shared_memory
        infos = self.infos[:getattr(self, 'shared_memory_file_limit',
                                    len(self.infos))]
        for info in infos:
            pc = info['point_cloud']
            key = self._sa_key(pc['lidar_sequence'], pc['sample_idx'])
            if not os.path.exists(f'/dev/shm/{key}'):
                continue
            try:
                shm = shared_memory.SharedMemory(name=key)
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass

    def include_waymo_data(self, mode):
        infos = []
        for seq in self.sample_sequence_list:
            seq_name = Path(seq).stem
            info_path = self.data_path / seq_name / f'{seq_name}.pkl'
            if not info_path.exists():
                continue
            with open(info_path, 'rb') as f:
                infos.extend(pickle.load(f))
        interval = int(self.dataset_cfg.get('SAMPLED_INTERVAL', {}).get(
            self.mode, 1)) if self.dataset_cfg.get('SAMPLED_INTERVAL') else 1
        self.infos = infos[::interval]
        self.frame_ids = [info['frame_id'] for info in self.infos]
        if self.logger is not None:
            self.logger.info('Total samples for Waymo dataset: %d',
                             len(self.infos))

    def get_lidar(self, sequence_name, sample_idx, from_shm=True):
        if from_shm and getattr(self, 'use_shared_memory', False):
            cached = self._get_lidar_shm(sequence_name, sample_idx)
            if cached is not None:
                return cached
        lidar_file = self.data_path / sequence_name / f'{sample_idx:04d}.npy'
        point_features = np.load(lidar_file)  # (N, 6): x, y, z, i, elong, nlz
        points_all = point_features[:, 0:5]
        nlz_flag = point_features[:, 5]
        points_all = points_all[nlz_flag == -1]
        points_all[:, 3] = np.tanh(points_all[:, 3])
        return points_all.astype(np.float32)

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = self.infos[index]
        pc_info = info['point_cloud']
        points = self.get_lidar(pc_info['lidar_sequence'],
                                pc_info['sample_idx'])
        input_dict = {'points': points, 'frame_id': info['frame_id']}
        if 'annos' in info:
            annos = info['annos']
            mask = annos['name'] != 'unknown'
            gt_boxes = annos['gt_boxes_lidar'][mask]
            input_dict.update({
                'gt_names': annos['name'][mask],
                'gt_boxes': gt_boxes[:, :7],
                'num_points_in_gt': annos.get('num_points_in_gt',
                                              None),
            })
        data_dict = self.prepare_data(data_dict=input_dict)
        data_dict.pop('num_points_in_gt', None)
        return data_dict

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        annos = []
        for index in range(batch_dict['batch_size']):
            valid = np.asarray(pred_dicts['pred_valid'][index])
            boxes = np.asarray(pred_dicts['pred_boxes'][index])[valid]
            scores = np.asarray(pred_dicts['pred_scores'][index])[valid]
            labels = np.asarray(pred_dicts['pred_labels'][index])[valid]
            annos.append({
                'frame_id': batch_dict['frame_id'][index],
                'name': np.array([class_names[l - 1] for l in labels]),
                'score': scores,
                'boxes_lidar': boxes,
                'pred_labels': labels,
                'metadata': batch_dict.get('metadata', [None] * 16)[index]
                if 'metadata' in batch_dict else None,
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        if 'annos' not in self.infos[0]:
            return 'No ground-truth boxes for evaluation', {}
        metric = kwargs.get('eval_metric', self.dataset_cfg.get(
            'EVAL_METRIC', 'kitti'))
        if metric == 'kitti':
            return self._kitti_style_eval(det_annos, class_names)
        if metric == 'waymo':
            return self._waymo_official_eval(det_annos, class_names)
        raise NotImplementedError(metric)

    def _kitti_style_eval(self, det_annos, class_names):
        """Parity: waymo_dataset.kitti_eval (:273-305) — map Vehicle→Car
        etc. and run the KITTI evaluator on lidar boxes."""
        from ..kitti.kitti_eval import eval as kitti_eval
        import copy
        map_name = {'Vehicle': 'Car', 'Pedestrian': 'Pedestrian',
                    'Cyclist': 'Cyclist', 'Sign': 'Sign', 'Car': 'Car'}

        def transform(annos):
            for anno in annos:
                anno['name'] = np.array(
                    [map_name.get(n, n) for n in anno['name']])
                boxes = anno.get('boxes_lidar', anno.get('gt_boxes_lidar'))
                if boxes is None:
                    boxes = np.zeros((0, 7))
                boxes = boxes.copy()
                n = len(boxes)
                anno['bbox'] = np.tile([0, 0, 50, 50.0], (n, 1))
                anno['truncated'] = np.zeros(n)
                anno['occluded'] = np.zeros(n)
                anno['alpha'] = np.full(n, -10.0)
                # lidar box → pseudo camera frame (x→-y, y→-z? kitti eval
                # uses location/dimensions/rotation_y in camera coords; the
                # reference builds them via boxes3d_lidar_to_kitti_camera
                # with a fake calib — here axis-permute like waymo_utils)
                anno['location'] = np.stack(
                    [-boxes[:, 1], -boxes[:, 2], boxes[:, 0]], axis=1) \
                    if n else np.zeros((0, 3))
                anno['dimensions'] = boxes[:, [3, 5, 4]] if n else np.zeros((0, 3))
                anno['rotation_y'] = -boxes[:, 6] - np.pi / 2 if n else np.zeros(0)
                if 'score' not in anno:
                    anno['score'] = np.zeros(n)
            return annos

        eval_det = transform(copy.deepcopy(det_annos))
        eval_gt = transform([
            {'name': info['annos']['name'],
             'gt_boxes_lidar': info['annos']['gt_boxes_lidar']}
            for info in self.infos])
        classes = [map_name.get(c, c) for c in class_names]
        return kitti_eval.get_official_eval_result(eval_gt, eval_det, classes)

    def _waymo_official_eval(self, det_annos, class_names):
        """Parity: waymo_dataset.waymo_eval (:306-325) — official mAP/mAPH
        L1/L2 through the waymo-open-dataset TF metric ops."""
        try:
            from .waymo_eval import OpenPCDetWaymoDetectionMetricsEstimator
            evaluator = OpenPCDetWaymoDetectionMetricsEstimator()
        except ImportError as e:
            return f'waymo-open-dataset unavailable ({e}); use kitti metric', {}
        import copy
        eval_det = copy.deepcopy(det_annos)
        eval_gt = copy.deepcopy([info['annos'] for info in self.infos])
        ap_dict = evaluator.waymo_evaluation(
            eval_det, eval_gt, class_name=class_names,
            distance_thresh=1000,
            fake_gt_infos=self.dataset_cfg.get('INFO_WITH_FAKELIDAR', False))
        ap_result_str = '\n'
        for key in ap_dict:
            ap_result_str += '%s: %.4f \n' % (key, ap_dict[key])
        return ap_result_str, ap_dict

    # ---- preprocessing CLI surface -----------------------------------------
    def get_infos(self, raw_data_path, save_path, num_workers=4,
                  has_label=True, sampled_interval=1):
        """tfrecords → per-frame npy + info pkls, in parallel (parity:
        waymo_dataset.get_infos :141-160)."""
        from . import waymo_utils
        fn = partial(waymo_utils.process_single_sequence,
                     save_path=Path(save_path),
                     sampled_interval=sampled_interval, has_label=has_label)
        seq_files = [Path(raw_data_path) / seq
                     for seq in self.sample_sequence_list]
        if num_workers > 1:
            with multiprocessing.Pool(num_workers) as pool:
                results = pool.map(fn, seq_files)
        else:
            results = [fn(f) for f in seq_files]
        return [item for seq_infos in results for item in seq_infos]

    def create_groundtruth_database(self, info_path, save_path,
                                    used_classes=None, split='train',
                                    sampled_interval=10,
                                    processed_data_tag=None):
        """GT-database for gt-sampling augmentation (parity:
        waymo_dataset.create_groundtruth_database :326-406, incl. the
        Vehicle-every-4th / Pedestrian-every-2nd subsampling quirks and the
        stacked global npy used by the shared-memory sampler)."""
        from ...ops.points_in_boxes import points_in_boxes_numpy
        save_path = Path(save_path)
        tag = processed_data_tag or 'waymo_processed_data'
        database_save_path = save_path / (
            '%s_gt_database_%s_sampled_%d' % (tag, split, sampled_interval))
        db_info_save_path = save_path / (
            '%s_waymo_dbinfos_%s_sampled_%d.pkl' % (tag, split,
                                                    sampled_interval))
        db_data_save_path = save_path / (
            '%s_gt_database_%s_sampled_%d_global.npy' % (tag, split,
                                                         sampled_interval))
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)

        point_offset_cnt = 0
        stacked_gt_points = []
        for k in range(0, len(infos), sampled_interval):
            info = infos[k]
            pc_info = info['point_cloud']
            sequence_name = pc_info['lidar_sequence']
            sample_idx = pc_info['sample_idx']
            points = self.get_lidar(sequence_name, sample_idx, from_shm=False)

            annos = info['annos']
            names = annos['name']
            difficulty = annos.get('difficulty', np.zeros(len(names)))
            gt_boxes = annos['gt_boxes_lidar']
            # reference quirks: drop Vehicles except every 4th frame,
            # Pedestrians except every 2nd (:352-362) to bound db size
            if k % 4 != 0 and len(names) > 0:
                keep = names != 'Vehicle'
                names, difficulty, gt_boxes = (names[keep], difficulty[keep],
                                               gt_boxes[keep])
            if k % 2 != 0 and len(names) > 0:
                keep = names != 'Pedestrian'
                names, difficulty, gt_boxes = (names[keep], difficulty[keep],
                                               gt_boxes[keep])
            if gt_boxes.shape[0] == 0:
                continue

            inside = points_in_boxes_numpy(points[:, :3], gt_boxes[:, :7])
            for i in range(gt_boxes.shape[0]):
                filename = '%s_%04d_%s_%d.bin' % (sequence_name, sample_idx,
                                                  names[i], i)
                filepath = database_save_path / filename
                gt_points = points[inside[:, i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                if used_classes is not None and names[i] not in used_classes:
                    continue
                gt_points.astype(np.float32).tofile(filepath)
                db_info = {
                    'name': names[i],
                    'path': str(filepath.relative_to(self.root_path)),
                    'sequence_name': sequence_name,
                    'sample_idx': sample_idx, 'gt_idx': i,
                    'box3d_lidar': gt_boxes[i],
                    'num_points_in_gt': gt_points.shape[0],
                    'difficulty': difficulty[i],
                    'global_data_offset': [
                        point_offset_cnt,
                        point_offset_cnt + gt_points.shape[0]],
                }
                stacked_gt_points.append(gt_points)
                point_offset_cnt += gt_points.shape[0]
                all_db_infos.setdefault(names[i], []).append(db_info)

        for k_, v in all_db_infos.items():
            print('Database %s: %d' % (k_, len(v)))
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)
        if stacked_gt_points:
            np.save(db_data_save_path,
                    np.concatenate(stacked_gt_points, axis=0))


def create_waymo_infos(dataset_cfg, class_names, data_path, save_path,
                       raw_data_tag='raw_data',
                       processed_data_tag='waymo_processed_data',
                       workers=4):
    """Parity: waymo_dataset.create_waymo_infos (:408-451) — train+val info
    pkls, then the train gt-database."""
    from ...utils.common import create_logger
    dataset = WaymoDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False,
                           logger=create_logger())
    train_split, val_split = 'train', 'val'
    train_filename = save_path / ('%s_infos_%s.pkl'
                                  % (processed_data_tag, train_split))
    val_filename = save_path / ('%s_infos_%s.pkl'
                                % (processed_data_tag, val_split))

    print('---------------Start to generate data infos---------------')
    dataset.set_split(train_split)
    infos_train = dataset.get_infos(
        raw_data_path=data_path / raw_data_tag,
        save_path=save_path / processed_data_tag, num_workers=workers,
        has_label=True, sampled_interval=1)
    with open(train_filename, 'wb') as f:
        pickle.dump(infos_train, f)
    print('Waymo train infos saved to %s' % train_filename)

    dataset.set_split(val_split)
    infos_val = dataset.get_infos(
        raw_data_path=data_path / raw_data_tag,
        save_path=save_path / processed_data_tag, num_workers=workers,
        has_label=True, sampled_interval=1)
    with open(val_filename, 'wb') as f:
        pickle.dump(infos_val, f)
    print('Waymo val infos saved to %s' % val_filename)

    print('---------------Start create groundtruth database---------------')
    create_groundtruth_database(dataset, save_path, processed_data_tag)
    print('---------------Data preparation Done---------------')


def create_groundtruth_database(dataset, save_path,
                                processed_data_tag='waymo_processed_data'):
    """The train split's gt database from
    ``<save_path>/<tag>_infos_train.pkl``: the second half of
    ``create_waymo_infos``, and on its own for processed data whose
    tfrecords were converted elsewhere."""
    dataset.set_split('train')
    dataset.create_groundtruth_database(
        info_path=save_path / ('%s_infos_train.pkl' % processed_data_tag),
        save_path=save_path, split='train', sampled_interval=1,
        used_classes=['Vehicle', 'Pedestrian', 'Cyclist'],
        processed_data_tag=processed_data_tag)


if __name__ == '__main__':
    import argparse
    REPO_ROOT = Path(__file__).resolve().parents[3]
    parser = argparse.ArgumentParser(description='arg parser')
    parser.add_argument('--cfg_file', type=str, default=None,
                        help='dataset config yaml')
    parser.add_argument('--func', type=str, default='create_waymo_infos',
                        choices=['create_waymo_infos',
                                 'create_groundtruth_database'])
    parser.add_argument('--data_path', type=str,
                        default=str(REPO_ROOT / 'data' / 'waymo'))
    parser.add_argument('--processed_data_tag', type=str,
                        default='waymo_processed_data')
    parser.add_argument('--workers', type=int, default=4)
    cli_args = parser.parse_args()
    from ...config import load_config
    from ...utils.common import create_logger
    dataset_cfg = load_config(cli_args.cfg_file)
    dataset_cfg.PROCESSED_DATA_TAG = cli_args.processed_data_tag
    root = Path(cli_args.data_path)
    if cli_args.func == 'create_waymo_infos':
        create_waymo_infos(
            dataset_cfg=dataset_cfg,
            class_names=['Vehicle', 'Pedestrian', 'Cyclist'],
            data_path=root, save_path=root,
            processed_data_tag=cli_args.processed_data_tag,
            workers=cli_args.workers)
    else:
        create_groundtruth_database(
            WaymoDataset(dataset_cfg=dataset_cfg,
                         class_names=['Vehicle', 'Pedestrian', 'Cyclist'],
                         root_path=root, training=False, logger=create_logger()),
            root, processed_data_tag=cli_args.processed_data_tag)
