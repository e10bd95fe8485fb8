"""KITTI label-file parsing.  Copy of
``crb_active_3ddet_tpu/datasets/kitti/object3d_kitti.py`` (parity:
``pcdet/utils/object3d_kitti.py``, the standard KITTI devkit label format)."""

from __future__ import annotations

import numpy as np


def cls_type_to_id(cls_type):
    type_to_id = {'Car': 1, 'Pedestrian': 2, 'Cyclist': 3, 'Van': 4}
    return type_to_id.get(cls_type, -1)


class Object3d:
    def __init__(self, line):
        label = line.strip().split(' ')
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array([float(x) for x in label[4:8]], np.float32)
        self.h, self.w, self.l = float(label[8]), float(label[9]), float(label[10])
        self.loc = np.array([float(x) for x in label[11:14]], np.float32)
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self):
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = 'Easy'
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = 'Moderate'
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = 'Hard'
            return 2
        self.level_str = 'UnKnown'
        return -1


def get_objects_from_label(label_file):
    with open(label_file, 'r') as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines]
