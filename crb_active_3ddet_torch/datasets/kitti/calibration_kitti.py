"""KITTI calibration file parsing + coordinate transforms (numpy).

Copy of ``crb_active_3ddet_tpu/datasets/kitti/calibration_kitti.py``
(parity: ``pcdet/utils/calibration_kitti.py``) — P2/R0/Tr_velo2cam matrices,
lidar↔rect↔image transforms. Standard KITTI devkit math.
"""

from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    obj = lines[2].strip().split(' ')[1:]
    P2 = np.array(obj, dtype=np.float32)
    obj = lines[3].strip().split(' ')[1:]
    P3 = np.array(obj, dtype=np.float32)
    obj = lines[4].strip().split(' ')[1:]
    R0 = np.array(obj, dtype=np.float32)
    obj = lines[5].strip().split(' ')[1:]
    Tr = np.array(obj, dtype=np.float32)
    return {'P2': P2.reshape(3, 4), 'P3': P3.reshape(3, 4),
            'R0': R0.reshape(3, 3), 'Tr_velo2cam': Tr.reshape(3, 4)}


class Calibration:
    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) \
            else get_calib_from_file(calib_file)
        self.P2 = calib['P2']
        self.R0 = calib['R0']
        self.V2C = calib['Tr_velo2cam']
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def rect_to_lidar(self, pts_rect):
        pts_rect_hom = self.cart_to_hom(pts_rect)
        R0_ext = np.eye(4, dtype=np.float32)
        R0_ext[:3, :3] = self.R0
        V2C_ext = np.eye(4, dtype=np.float32)
        V2C_ext[:3, :4] = self.V2C
        pts_lidar = pts_rect_hom @ np.linalg.inv((R0_ext @ V2C_ext).T)
        return pts_lidar[:, 0:3]

    def lidar_to_rect(self, pts_lidar):
        pts_lidar_hom = self.cart_to_hom(pts_lidar)
        return pts_lidar_hom @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect):
        pts_rect_hom = self.cart_to_hom(pts_rect)
        pts_2d_hom = pts_rect_hom @ self.P2.T
        pts_img = (pts_2d_hom[:, 0:2].T / pts_rect_hom[:, 2]).T
        pts_rect_depth = pts_2d_hom[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_rect_depth

    def lidar_to_img(self, pts_lidar):
        pts_rect = self.lidar_to_rect(pts_lidar)
        return self.rect_to_img(pts_rect)

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate(
            [x.reshape(-1, 1), y.reshape(-1, 1), depth_rect.reshape(-1, 1)], axis=1)


def dummy_calibration(image_shape=(375, 1242)):
    """Identity-ish calibration for synthetic/demo scenes."""
    P2 = np.array([[700.0, 0, image_shape[1] / 2, 0],
                   [0, 700.0, image_shape[0] / 2, 0],
                   [0, 0, 1, 0]], np.float32)
    R0 = np.eye(3, dtype=np.float32)
    # lidar (x fwd, y left, z up) → camera (x right, y down, z fwd)
    Tr = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], np.float32)
    return Calibration({'P2': P2, 'P3': P2.copy(), 'R0': R0, 'Tr_velo2cam': Tr})
