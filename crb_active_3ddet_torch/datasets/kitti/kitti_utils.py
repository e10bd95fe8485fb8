"""KITTI-format conversion helpers.

Copy of ``crb_active_3ddet_tpu/datasets/kitti/kitti_utils.py`` (parity:
``pcdet/datasets/kitti/kitti_utils.py``) —
``transform_annotations_to_kitti_format`` (:5-50) maps lyft/nuscenes-style
lidar annos into camera-frame KITTI annos (with the reference's dummy 50px
bboxes) so the KITTI evaluator can score them, and ``calib_to_matricies``
(:52-66) builds (V2R, P2) — our KittiDataset computes those inline.
"""

from __future__ import annotations

import numpy as np

from ...utils import box_utils


def transform_annotations_to_kitti_format(annos, map_name_to_kitti=None,
                                          info_with_fakelidar=False):
    for anno in annos:
        if 'name' not in anno:
            anno['name'] = anno['gt_names']
            anno.pop('gt_names')
        for k in range(anno['name'].shape[0]):
            anno['name'][k] = map_name_to_kitti[anno['name'][k]]

        anno['bbox'] = np.zeros((len(anno['name']), 4))
        anno['bbox'][:, 2:4] = 50       # dummy [0, 0, 50, 50] boxes
        anno['truncated'] = np.zeros(len(anno['name']))
        anno['occluded'] = np.zeros(len(anno['name']))
        if 'boxes_lidar' in anno:
            gt_boxes_lidar = anno['boxes_lidar'].copy()
        else:
            gt_boxes_lidar = anno['gt_boxes'].copy() \
                if 'gt_boxes' in anno else anno['gt_boxes_lidar'].copy()
        gt_boxes_lidar = np.asarray(gt_boxes_lidar)[:, :7]

        if len(gt_boxes_lidar) > 0:
            if info_with_fakelidar:
                gt_boxes_lidar = box_utils.boxes3d_kitti_fakelidar_to_lidar(
                    gt_boxes_lidar)
            gt_boxes_lidar[:, 2] -= gt_boxes_lidar[:, 5] / 2
            anno['location'] = np.zeros((gt_boxes_lidar.shape[0], 3))
            anno['location'][:, 0] = -gt_boxes_lidar[:, 1]   # x = -y_lidar
            anno['location'][:, 1] = -gt_boxes_lidar[:, 2]   # y = -z_lidar
            anno['location'][:, 2] = gt_boxes_lidar[:, 0]    # z = x_lidar
            dxdydz = gt_boxes_lidar[:, 3:6]
            anno['dimensions'] = dxdydz[:, [0, 2, 1]]        # lwh → lhw
            anno['rotation_y'] = -gt_boxes_lidar[:, 6] - np.pi / 2.0
            anno['alpha'] = -np.arctan2(-gt_boxes_lidar[:, 1],
                                        gt_boxes_lidar[:, 0]) \
                + anno['rotation_y']
        else:
            anno['location'] = anno['dimensions'] = np.zeros((0, 3))
            anno['rotation_y'] = anno['alpha'] = np.zeros(0)
    return annos


# name used at some reference call sites (lyft_dataset.py:165)
transform_to_kitti_format = transform_annotations_to_kitti_format
