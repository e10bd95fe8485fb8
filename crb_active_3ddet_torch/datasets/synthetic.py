"""Synthetic LiDAR dataset — deterministic generated scenes.

No counterpart in the reference (it has no test suite, SURVEY.md §4); this
dataset powers unit/integration tests, bench.py, and demo runs without KITTI
on disk.  It exposes the same surface as KittiDataset (sample_id_list +
infos + generate_prediction_dicts/evaluation) so the AL loop and trainers
are exercised identically.

Scenes: ground-plane clutter + per-class box clusters with class-typical
sizes; boxes are the labels. Deterministic per (seed, index).
"""

from __future__ import annotations

import numpy as np

from .dataset import DatasetTemplate

CLASS_SIZES = {
    'Car': (3.9, 1.6, 1.56, -1.0),
    'Vehicle': (4.7, 2.1, 1.7, -0.8),     # waymo-style class name
    'Pedestrian': (0.8, 0.6, 1.73, -0.8),
    'Cyclist': (1.76, 0.6, 1.73, -0.8),
}
# classes outside the KITTI/Waymo families (nuscenes/lyft names) get a
# deterministic generic size so any config's CLASS_NAMES can be synthesized
_GENERIC_SIZE = (2.8, 1.4, 1.5, -1.0)


def _make_scene(rng, class_names, pc_range, num_bg=4096, max_objects=12,
                points_per_obj=(60, 300), extra_feats=1, box_extra_dim=0,
                min_separation=0.0, empty_fraction=0.0):
    x0, y0, z0, x1, y1, z1 = pc_range
    bg = np.stack([
        rng.uniform(x0, x1, num_bg), rng.uniform(y0, y1, num_bg),
        rng.normal(-1.6, 0.12, num_bg),
        *[rng.uniform(0, 1, num_bg) for _ in range(extra_feats)],
    ], axis=1).astype(np.float32)

    # heterogeneous-pool mode (AL tests): a fraction of scenes carry no
    # objects at all, so informed acquisition has junk frames to avoid
    if empty_fraction > 0 and rng.uniform() < empty_fraction:
        return (bg, np.zeros((0, 7 + box_extra_dim), np.float32),
                np.asarray([], dtype='<U16'))

    n_obj = rng.randint(1, max_objects + 1)
    boxes, names, pts = [], [], [bg]
    for _ in range(n_obj):
        name = class_names[rng.randint(len(class_names))]
        dx, dy, dz, zc = CLASS_SIZES.get(name, _GENERIC_SIZE)
        dx *= rng.uniform(0.9, 1.1)
        dy *= rng.uniform(0.9, 1.1)
        dz *= rng.uniform(0.95, 1.05)
        cx = rng.uniform(x0 + 3, x1 - 3)
        cy = rng.uniform(y0 + 2, y1 - 2)
        if min_separation > 0:
            # easy-scene mode (detection-quality gate): resample the center
            # until it clears every placed box, so labels are unambiguous;
            # if retries exhaust, drop the object rather than place an
            # overlapping box that would violate that premise
            for _retry in range(16):
                if all((cx - b[0]) ** 2 + (cy - b[1]) ** 2
                       >= min_separation ** 2 for b in boxes):
                    break
                cx = rng.uniform(x0 + 3, x1 - 3)
                cy = rng.uniform(y0 + 2, y1 - 2)
            else:
                continue
        heading = rng.uniform(-np.pi, np.pi)
        npts = rng.randint(*points_per_obj)
        local = rng.uniform(-0.5, 0.5, (npts, 3)) * np.array([dx, dy, dz])
        ca, sa = np.cos(heading), np.sin(heading)
        world = np.stack([
            local[:, 0] * ca - local[:, 1] * sa + cx,
            local[:, 0] * sa + local[:, 1] * ca + cy,
            local[:, 2] + zc,
        ], axis=1)
        feats = rng.uniform(0, 1, (npts, extra_feats))
        pts.append(np.concatenate([world, feats], axis=1).astype(np.float32))
        box = [cx, cy, zc, dx, dy, dz, heading]
        if box_extra_dim:  # e.g. (vx, vy) velocity for nuscenes-style boxes
            box += list(rng.uniform(-2, 2, box_extra_dim))
        boxes.append(box)
        names.append(name)
    points = np.concatenate(pts, axis=0)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7 + box_extra_dim)
    return points, boxes, np.asarray(names)


class SyntheticDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path or '/tmp',
                         logger=logger)
        self.num_scenes = int(dataset_cfg.get('NUM_SCENES', 64))
        self.seed = int(dataset_cfg.get('SEED', 1234))
        split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.split_offset = 0 if split == 'train' else 100_000
        # KittiDataset-parity identity surface for the AL layer
        self.sample_id_list = [f'{self.split_offset + i:06d}'
                               for i in range(self.num_scenes)]
        self.infos = [{'frame_id': sid, 'point_cloud': {'lidar_idx': sid}}
                      for sid in self.sample_id_list]
        self.kitti_infos = self.infos  # alias, kitti-style attr name
        # scene cache: real datasets read fixed frames from disk (~ms); the
        # generator costs tens of ms per frame on a small host, which would
        # dominate AL pool scans that touch every frame each round
        self._scene_cache = {}

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.sample_id_list) * self.total_epochs
        return len(self.sample_id_list)

    def get_scene(self, sample_id: str):
        cached = self._scene_cache.get(sample_id)
        if cached is not None:
            points, boxes, names = cached
            return points.copy(), boxes.copy(), names.copy()
        rng = np.random.RandomState(self.seed + int(sample_id))
        n_feat = len(self.dataset_cfg.POINT_FEATURE_ENCODING.src_feature_list)
        ppo = self.dataset_cfg.get('POINTS_PER_OBJECT', (60, 300))
        scene = _make_scene(rng, self.class_names,
                            self.point_cloud_range,
                            num_bg=int(self.dataset_cfg.get('NUM_BG_POINTS', 4096)),
                            max_objects=int(self.dataset_cfg.get('MAX_OBJECTS', 12)),
                            points_per_obj=(int(ppo[0]), int(ppo[1])),
                            extra_feats=max(n_feat - 3, 0),
                            box_extra_dim=int(self.dataset_cfg.get(
                                'GT_BOX_EXTRA_DIM', 0)),
                            min_separation=float(self.dataset_cfg.get(
                                'MIN_SEPARATION', 0.0)),
                            empty_fraction=float(self.dataset_cfg.get(
                                'EMPTY_FRACTION', 0.0)))
        self._scene_cache[sample_id] = scene
        points, boxes, names = scene
        return points.copy(), boxes.copy(), names.copy()

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.sample_id_list)
        sample_id = self.sample_id_list[index]
        points, gt_boxes, gt_names = self.get_scene(sample_id)
        input_dict = {
            'points': points,
            'gt_boxes': gt_boxes,
            'gt_names': gt_names,
            'frame_id': sample_id,
        }
        get_item_list = set(self.dataset_cfg.get('GET_ITEM_LIST', ['points']))
        if 'images' in get_item_list:
            input_dict.update(self._make_camera(sample_id, points, gt_boxes))
            if 'points' not in get_item_list:
                input_dict.pop('points')
        return self.prepare_data(input_dict)

    def _make_camera(self, sample_id, points, gt_boxes):
        """Fabricated camera frame for CaDDN-shaped models: KITTI-style
        lidar→cam axis permutation, pinhole intrinsics, image from smooth
        noise, depth map from projected scene points, boxes2d from projected
        3D corners."""
        rng = np.random.RandomState(self.seed + 7 + int(sample_id))
        h, w = (int(x) for x in self.dataset_cfg.get('IMAGE_SHAPE', (96, 320)))
        # lidar (x fwd, y left, z up) → cam (x right, y down, z fwd)
        l2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                        [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
        f = w * 0.8
        p2 = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0]],
                      np.float32)
        image = rng.rand(h // 8, w // 8, 3).astype(np.float32)
        image = np.repeat(np.repeat(image, 8, 0), 8, 1)

        cam = (l2c[:3, :3] @ points[:, :3].T).T
        uvw = (p2[:, :3] @ cam.T).T
        depth_map = np.full((h, w), np.nan, np.float32)
        zs = uvw[:, 2]
        okz = zs > 0.5
        us = (uvw[okz, 0] / zs[okz]).astype(np.int64)
        vs = (uvw[okz, 1] / zs[okz]).astype(np.int64)
        okp = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
        depth_map[vs[okp], us[okp]] = zs[okz][okp]
        depth_map = np.where(np.isnan(depth_map),
                             rng.uniform(2, 40, (h, w)).astype(np.float32),
                             depth_map)

        boxes2d = []
        from ..utils import box_utils
        corners = box_utils.boxes_to_corners_3d(gt_boxes[:, :7]) \
            if len(gt_boxes) else np.zeros((0, 8, 3))
        for c in corners:
            cc = (l2c[:3, :3] @ c.T).T
            uv = (p2[:, :3] @ cc.T).T
            z = np.clip(uv[:, 2], 0.1, None)
            u, v = uv[:, 0] / z, uv[:, 1] / z
            boxes2d.append([max(u.min(), 0), max(v.min(), 0),
                            min(u.max(), w - 1), min(v.max(), h - 1)])
        return {
            'images': image,
            'depth_maps': depth_map,
            'trans_lidar_to_cam': l2c,
            'trans_cam_to_img': p2,
            'image_shape': np.array([h, w], np.int32),
            'gt_boxes2d': np.asarray(boxes2d, np.float32).reshape(-1, 4),
        }

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Fixed-shape device preds → per-frame numpy annos (lidar frame).

        Mirrors KittiDataset.generate_prediction_dicts but stays in lidar
        coordinates (no calib for synthetic scenes).
        """
        annos = []
        for i in range(batch_dict['batch_size']):
            valid = np.asarray(pred_dicts['pred_valid'][i])
            boxes = np.asarray(pred_dicts['pred_boxes'][i])[valid]
            scores = np.asarray(pred_dicts['pred_scores'][i])[valid]
            labels = np.asarray(pred_dicts['pred_labels'][i])[valid]
            annos.append({
                'frame_id': batch_dict['frame_id'][i],
                'name': np.array([class_names[l - 1] for l in labels]),
                'score': scores,
                'boxes_lidar': boxes,
                'pred_labels': labels,
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """Simple lidar-frame AP (IoU-matched PR over score sweep) — the
        synthetic stand-in for KITTI official eval."""
        from ..utils.simple_eval import evaluate_lidar_ap
        gt_annos = []
        for det in det_annos:
            _, boxes, names = self.get_scene(det['frame_id'])
            gt_annos.append({'boxes_lidar': boxes, 'name': names})
        ap_dict = evaluate_lidar_ap(det_annos, gt_annos, class_names)
        ap_str = '\n'.join(f'{k}: {v:.4f}' for k, v in ap_dict.items())
        return ap_str, ap_dict
