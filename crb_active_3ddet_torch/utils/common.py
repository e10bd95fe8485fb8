"""Common utilities: device choice, f32 precision, angle wrapping, rotation,
logging, seeds.

Host-side numpy parts copied from ``crb_active_3ddet_tpu/utils/common.py``
(limit_period, rotate_points_along_z*, get_voxel_centers, create_logger,
set_random_seed, AverageMeter); ``limit_period``, ``rotate_points_along_z``
and ``get_voxel_centers`` also take torch tensors.
"""

from __future__ import annotations

import contextlib
import logging
import random

import numpy as np
import torch


def resolve_device(device='cuda') -> torch.device:
    """The port's device rule: CUDA unless the caller asks for the CPU.

    Raises when CUDA is asked for (the default) and no card is present —
    nothing falls back to the CPU on its own.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_f32():
    """Float32 work computes in float32 while the block runs: TF32 off in
    cuDNN's convolutions (PyTorch's default lets them round f32 operands to
    TF32's 10-bit mantissa) and in cuBLAS's matmuls, the earlier settings
    restored after.  The configs' f32 layers mean f32, as in the JAX
    package on the CPU; a config's bf16 layers cast their operands
    themselves."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def geometry(dataset):
    """(voxel_cfg, grid_size, point_cloud_range, voxel_size) of a dataset as
    the device step takes them, tuples of ints and floats; a points-only
    dataset (no voxel processor) has None for all but the range."""
    def tup(x, kind):
        return None if x is None else tuple(kind(v) for v in x)
    return (dataset.voxel_cfg, tup(dataset.grid_size, int),
            tup(dataset.point_cloud_range, float), tup(dataset.voxel_size, float))


def take_rows(x, idx):
    """x (B, A, ...) rows at idx (B, P) → (B, P, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.ndim - 2)))
                        .expand(*idx.shape, *x.shape[2:]))


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angles into [-offset*period, (1-offset)*period).

    Mirrors ``common_utils.limit_period`` (`common_utils.py:60-63`).
    Works for numpy and torch inputs.
    """
    if isinstance(val, torch.Tensor):
        return val - torch.floor(val / period + offset) * period
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """Rotate batched points about the z axis.

    points: (B, N, 3 + C), angle: (B,).  A copy of the JAX package's
    function, which applies the transpose of the matrix of
    ``common_utils.rotate_points_along_z`` (`common_utils.py:35-57`): a
    positive angle turns (1, 0, 0) towards (0, −1, 0).  Works for numpy and
    torch inputs.
    """
    if isinstance(points, torch.Tensor):
        cosa, sina = torch.cos(angle), torch.sin(angle)
        zeros, ones = torch.zeros_like(angle), torch.ones_like(angle)
        rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros,
                           zeros, zeros, ones], dim=-1).reshape(-1, 3, 3)
        xyz = torch.einsum('bnc,bdc->bnd', points[..., :3], rot)
        return torch.cat([xyz, points[..., 3:]], dim=-1)
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack([
        cosa, sina, zeros,
        -sina, cosa, zeros,
        zeros, zeros, ones,
    ], axis=-1).reshape(-1, 3, 3)
    xyz = np.einsum('bnc,bdc->bnd', points[..., :3], rot)
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def rotate_points_along_z_single(points, angle):
    """Rotate (N, 3+C) points by a scalar angle (host-side numpy augmentor)."""
    cosa, sina = np.cos(angle), np.sin(angle)
    rot = np.array([[cosa, sina, 0.0], [-sina, cosa, 0.0], [0.0, 0.0, 1.0]],
                   dtype=points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot.T
    return out


def get_voxel_centers(voxel_coords, downsample_times, voxel_size, point_cloud_range):
    """Voxel-index (..., 3) (z, y, x int coords) → metric centers.

    Mirrors ``common_utils.get_voxel_centers`` (`common_utils.py:66-82`).
    Works for numpy and torch inputs.
    """
    if isinstance(voxel_coords, torch.Tensor):
        coords = voxel_coords[..., [2, 1, 0]].to(torch.float32)
        size = torch.tensor(voxel_size, dtype=torch.float32,
                            device=coords.device) * downsample_times
        start = torch.tensor(point_cloud_range[0:3], dtype=torch.float32,
                             device=coords.device)
        return (coords + 0.5) * size + start
    coords = voxel_coords[..., [2, 1, 0]].astype(np.float32)
    voxel_size = np.asarray(voxel_size) * downsample_times
    pc_range = np.asarray(point_cloud_range[0:3])
    return (coords + 0.5) * voxel_size + pc_range


def create_logger(log_file=None, rank: int = 0, log_level=logging.INFO):
    """Per-rank logger (rank>0 silenced), console + optional file.

    Mirrors ``common_utils.create_logger`` (`common_utils.py:85-99`).
    """
    logger = logging.getLogger(f'crb3d_torch.r{rank}.{log_file}')
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else logging.ERROR)
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setLevel(log_level if rank == 0 else logging.ERROR)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger


def set_random_seed(seed: int = 666) -> torch.Generator:
    """Seed host-side RNGs (numpy/python) and return a CPU
    ``torch.Generator`` for device-side randomness (reference seeds:
    `tools/train.py:91` 666, `tools/test.py:53` 1024)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


class AverageMeter:
    """Running mean tracker (reference `common_utils.py:110-127`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
