"""Official Waymo detection metrics (mAP/mAPH at L1/L2).

Copy of ``crb_active_3ddet_tpu/datasets/waymo/waymo_eval.py`` (parity:
``pcdet/datasets/waymo/waymo_eval.py``
OpenPCDetWaymoDetectionMetricsEstimator :23: type-result extraction,
distance masking, OBJECT_TYPE and RANGE breakdowns, LEVEL_1/LEVEL_2).  The
metric ops come from ``waymo-open-dataset`` and TensorFlow, imported inside a
``try``; without them the estimator's ``__init__`` raises ``ImportError``,
while its numpy seams (``generate_waymo_type_results``, ``mask_by_distance``)
and ``limit_period`` work on an estimator made without ``__init__``.  The
estimator computes the metrics eagerly through the ``py_metrics_ops``
wrapper instead of the reference's TF1 graph and session.
"""

from __future__ import annotations

import numpy as np

# waymo-open-dataset before tensorflow, as in waymo_utils.py
try:  # pragma: no cover - needs waymo-open-dataset
    from waymo_open_dataset import label_pb2
    from waymo_open_dataset.metrics.python import config_util_py as config_util
    from waymo_open_dataset.metrics.python import detection_metrics
    from waymo_open_dataset.protos import metrics_pb2
    import tensorflow as tf
    _WAYMO_EVAL_OK = True
except Exception:  # pragma: no cover
    _WAYMO_EVAL_OK = False

CLASS_TO_TYPE = {'Vehicle': 1, 'Pedestrian': 2, 'Sign': 3, 'Cyclist': 4}


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


class OpenPCDetWaymoDetectionMetricsEstimator:
    """Compute official Waymo detection metrics from OpenPCDet-style annos."""

    def __init__(self):
        if not _WAYMO_EVAL_OK:
            raise ImportError(
                'waymo-open-dataset is required for official Waymo metrics; '
                'install waymo-open-dataset-tf-2-* or use EVAL_METRIC: kitti')

    # ---- anno extraction ---------------------------------------------------
    def generate_waymo_type_results(self, infos, class_names, is_gt=False,
                                    fake_gt_infos=True):
        """Flatten per-frame annos to stacked arrays keyed by frame index.
        Returns (frame_id, boxes3d (N,7), type, score, overlap_nlz,
        difficulty)."""
        frame_id, boxes3d, obj_type, score, overlap_nlz, difficulty = \
            [], [], [], [], [], []
        for fidx, info in enumerate(infos):
            if is_gt:
                info = info['annos'] if 'annos' in info else info
                names = info['name']
                keep = np.array([n in class_names for n in names], bool)
                names = names[keep]
                boxes = info['gt_boxes_lidar'][keep]
                if boxes.shape[-1] == 9:   # with velocity
                    boxes = boxes[:, [0, 1, 2, 3, 4, 5, 8]] \
                        if not fake_gt_infos else boxes[:, :7]
                diff = info.get('difficulty', np.zeros(len(names)))[keep] \
                    if 'difficulty' in info else np.zeros(keep.sum())
                npts = info.get('num_points_in_gt',
                                np.full(len(keep), 10))[keep] \
                    if 'num_points_in_gt' in info else np.full(int(keep.sum()), 10)
                # LEVEL assignment (reference :56-64): difficulty 0 → L1 if
                # >5 points else L2; drop empty boxes
                diff = np.asarray(diff).copy()
                npts = np.asarray(npts)
                diff[(diff == 0) & (npts > 5)] = 1
                diff[(diff == 0) & (npts <= 5)] = 2
                nonzero = npts > 0
                names, boxes, diff = names[nonzero], boxes[nonzero], \
                    diff[nonzero]
                sc = np.ones(len(names))
            else:
                names = info['name']
                boxes = info['boxes_lidar']
                sc = info['score']
                diff = np.zeros(len(names))
            frame_id.append(np.full(len(names), fidx, np.int64))
            boxes3d.append(np.asarray(boxes).reshape(-1, 7))
            obj_type.append(np.array(
                [CLASS_TO_TYPE.get(n, 0) for n in names], np.uint8))
            score.append(np.asarray(sc, np.float32))
            overlap_nlz.append(np.zeros(len(names), bool))
            difficulty.append(np.asarray(diff, np.uint8))
        return (np.concatenate(frame_id), np.concatenate(boxes3d),
                np.concatenate(obj_type), np.concatenate(score),
                np.concatenate(overlap_nlz), np.concatenate(difficulty))

    def mask_by_distance(self, distance_thresh, boxes_3d, *args):
        mask = np.linalg.norm(boxes_3d[:, :2], axis=1) < distance_thresh + 0.5
        return (boxes_3d[mask],) + tuple(a[mask] for a in args)

    # ---- metric config -----------------------------------------------------
    def build_config(self):
        cfg_text = '''
        breakdown_generator_ids: OBJECT_TYPE
        difficulties { levels: 1 levels: 2 }
        breakdown_generator_ids: RANGE
        difficulties { levels: 1 levels: 2 }
        matcher_type: TYPE_HUNGARIAN
        iou_thresholds: 0.0
        iou_thresholds: 0.7
        iou_thresholds: 0.5
        iou_thresholds: 0.5
        iou_thresholds: 0.5
        box_type: TYPE_3D
        '''
        cfg = metrics_pb2.Config()
        from google.protobuf import text_format
        text_format.Merge(cfg_text, cfg)
        for x in range(0, 100, 5):
            cfg.score_cutoffs.append(x * 0.01)
        cfg.score_cutoffs.append(1.0)
        return cfg

    # ---- the evaluation ----------------------------------------------------
    def waymo_evaluation(self, prediction_infos, gt_infos, class_name,
                         distance_thresh=100, fake_gt_infos=True):
        assert len(prediction_infos) == len(gt_infos)
        pd = self.generate_waymo_type_results(
            prediction_infos, class_name, is_gt=False)
        gt = self.generate_waymo_type_results(
            gt_infos, class_name, is_gt=True, fake_gt_infos=fake_gt_infos)
        pd_fid, pd_box, pd_type, pd_score, _, _ = pd
        gt_fid, gt_box, gt_type, _, gt_nlz, gt_diff = gt
        pd_box, pd_fid, pd_type, pd_score = self.mask_by_distance(
            distance_thresh, pd_box, pd_fid, pd_type, pd_score)
        gt_box, gt_fid, gt_type, gt_nlz, gt_diff = self.mask_by_distance(
            distance_thresh, gt_box, gt_fid, gt_type, gt_nlz, gt_diff)

        cfg = self.build_config()
        metrics = detection_metrics.get_detection_metric_ops(
            config=cfg,
            prediction_frame_id=tf.constant(pd_fid, tf.int64),
            prediction_bbox=tf.constant(pd_box, tf.float32),
            prediction_type=tf.constant(pd_type, tf.uint8),
            prediction_score=tf.constant(pd_score, tf.float32),
            prediction_overlap_nlz=tf.zeros_like(
                tf.constant(pd_fid), tf.bool),
            ground_truth_frame_id=tf.constant(gt_fid, tf.int64),
            ground_truth_bbox=tf.constant(gt_box, tf.float32),
            ground_truth_type=tf.constant(gt_type, tf.uint8),
            ground_truth_difficulty=tf.constant(gt_diff, tf.uint8),
            ground_truth_speed=None,
        )
        breakdown_names = config_util.get_breakdown_names_from_config(cfg)
        ap_dict = {}
        for i, name in enumerate(breakdown_names):
            ap_dict[f'{name}/AP'] = float(np.asarray(
                metrics['average_precision'][i]))
            ap_dict[f'{name}/APH'] = float(np.asarray(
                metrics['average_precision_ha_weighted'][i]))
        return ap_dict
