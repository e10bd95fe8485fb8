"""Farthest point sampling: wrapper of the CUDA kernel ``csrc/fps.cu``.

Counterpart of ``crb_active_3ddet_tpu/ops/pallas_kernels.py:148
farthest_point_sample_pallas``, batched over frames: (B, N, 3) points and a
(B, N) validity mask give (B, K) int32 indices.  Each frame starts at index 0,
keeps every point's minimum squared distance to the chosen set and picks the
argmax each step, ties to the lowest index; invalid points are held at −1e10
(so with fewer valid points than K the lowest-index valid point repeats, and
a frame without valid points returns index 0 throughout).

On CUDA tensors the wrapper launches the kernel once for the whole batch (or
raises): a cluster of 8 thread blocks a frame, each holding an eighth of the
frame's points in registers, at most ``max_points()`` (45 056) a frame.  The
kernel has two instances, 24 and 44 points a thread; a frame of at most
24 576 points runs on the first.  On CPU tensors it runs the plain version
below, a K-step loop with the same arithmetic written out the same way.  The selection is exact: one differing index would
change every later one.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_BIG = 1e10

launches = 0

_SIG = {'fps_launch': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
        'fps_max_points': []}


def fps_plain(points, valid, num_samples: int):
    """Plain torch version: (B, N, 3) f32, (B, N) bool → (B, K) int32."""
    b, n, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    neg = torch.full_like(x, -_BIG)
    dist = torch.where(valid, torch.full_like(x, _BIG), neg)
    ar = torch.arange(n, device=points.device).expand(b, n)
    sentinel = torch.full_like(ar, n)
    last = torch.zeros((b, 1), dtype=torch.int64, device=points.device)
    out = [last]
    for _ in range(1, num_samples):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        d = dx * dx + dy * dy + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d, neg))
        top = dist.max(dim=1, keepdim=True).values
        # first index of the maximum, whatever the backend's argmax does on ties
        last = torch.where(dist == top, ar, sentinel).min(dim=1, keepdim=True).values
        out.append(last)
    return torch.cat(out, dim=1).to(torch.int32)


def farthest_point_sample_cuda(points, valid, num_samples: int):
    """points (B, N, 3) f32; valid (B, N) bool → (B, num_samples) int32."""
    if points.ndim != 3 or points.shape[-1] != 3 or valid.shape != points.shape[:2]:
        raise ValueError(f'FPS: shapes {tuple(points.shape)}, {tuple(valid.shape)}')
    if points.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f'FPS: points must be float32 and valid bool, got '
                        f'{points.dtype}, {valid.dtype}')
    if points.shape[1] < 1 or num_samples < 1:
        raise ValueError('FPS: needs at least one point and one sample')
    if points.device.type == 'cpu':
        return fps_plain(points, valid, num_samples)
    return _launch(points, valid, num_samples)


def max_points():
    """Most points a frame may hold on the card (builds the kernel if needed)."""
    return cuda_build.load_library('fps', _SIG).fps_max_points()


def _launch(points, valid, num_samples):
    global launches
    dev = points.device
    if dev.type != 'cuda' or valid.device != dev:
        raise ValueError('FPS: both tensors must be on one CUDA device')
    b, n, _ = points.shape
    lib = cuda_build.load_library('fps', _SIG)
    if n > lib.fps_max_points():
        raise ValueError(f'FPS: {n} points a frame, the kernel is built for '
                         f'at most {lib.fps_max_points()}')
    points, valid = points.contiguous(), valid.contiguous()
    out = torch.empty((b, num_samples), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fps_launch(points.data_ptr(), valid.data_ptr(), out.data_ptr(),
                             b, n, num_samples, stream)
    cuda_build.check(lib, 'fps', err)
    launches += 1
    return out
