"""Rotated BEV overlap matrix: wrapper of the CUDA kernel ``csrc/overlap_bev.cu``.

Counterpart of ``crb_active_3ddet_tpu/ops/pallas_overlap.py:122
boxes_overlap_bev_pallas``: for (..., N, 7) × (..., M, 7) boxes, the area of
the intersection of every pair of rotated BEV rectangles.  A's 4 CCW corners
are clipped against B's 4 edges (Sutherland–Hodgman, ≤ 8 vertices), then the
shoelace area is taken.  Zero (degenerate) A boxes give 0.

On CUDA tensors the wrapper launches the kernel once for the whole batch (or
raises); on CPU tensors it runs the plain version below, which vectorises the
same 8-slot clip over whole tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

_EPS = 1e-8
_CAP = 8          # max vertices of the intersection of two convex quads
_ROW_CHUNK = 128  # plain version: rows per step, bounds its temporaries

launches = 0

_SIG = {'overlap_bev_launch': [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]}


def corners_xy(boxes):
    """(..., 7) → corner tensors x, y each (..., 4), CCW."""
    dx2, dy2 = boxes[..., 3] / 2.0, boxes[..., 4] / 2.0
    lx = torch.stack([dx2, -dx2, -dx2, dx2], dim=-1)
    ly = torch.stack([dy2, dy2, -dy2, -dy2], dim=-1)
    cosa = torch.cos(boxes[..., 6])[..., None]
    sina = torch.sin(boxes[..., 6])[..., None]
    cx = lx * cosa - ly * sina + boxes[..., 0:1]
    cy = lx * sina + ly * cosa + boxes[..., 1:2]
    return cx, cy


def corners_cat(boxes):
    """(..., 7) → (..., 8) f32 [cx0..3, cy0..3] CCW corners."""
    cx, cy = corners_xy(boxes.to(torch.float32))
    return torch.cat([cx, cy], dim=-1).contiguous()


def _clip_halfplane_slots(px, py, n, e1x, e1y, e2x, e2y):
    """One Sutherland–Hodgman stage on per-slot tensors (same arithmetic,
    candidate order and compaction as the Pallas ``_clip_halfplane_slots``).
    px, py: lists of _CAP tensors; n: vertex count tensor; e*: edge ends."""
    ex, ey = e2x - e1x, e2y - e1y
    d = [ex * (py[i] - e1y) - ey * (px[i] - e1x) for i in range(_CAP)]
    cand_x, cand_y, flags = [], [], []
    for i in range(_CAP):
        nxt_ok = (i + 1) < n
        j = (i + 1) % _CAP
        dn = torch.where(nxt_ok, d[j], d[0])
        vnx = torch.where(nxt_ok, px[j], px[0])
        vny = torch.where(nxt_ok, py[j], py[0])
        valid = i < n
        inside = d[i] >= 0.0
        inside_n = dn >= 0.0
        denom = d[i] - dn
        t = d[i] / torch.where(torch.abs(denom) < _EPS,
                               torch.ones_like(denom), denom)
        cand_x += [px[i], px[i] + t * (vnx - px[i])]
        cand_y += [py[i], py[i] + t * (vny - py[i])]
        flags += [inside & valid, (inside != inside_n) & valid]
    new_px = [torch.zeros_like(px[0]) for _ in range(_CAP)]
    new_py = [torch.zeros_like(py[0]) for _ in range(_CAP)]
    cnt = torch.zeros_like(n)
    for jc in range(2 * _CAP):
        f = flags[jc]
        for s in range(min(jc + 1, _CAP)):
            hit = f & (cnt == s)
            new_px[s] = torch.where(hit, cand_x[jc], new_px[s])
            new_py[s] = torch.where(hit, cand_y[jc], new_py[s])
        cnt = cnt + f.to(cnt.dtype)
    return new_px, new_py, cnt


def _overlap_corners_plain(a_cor, b_cor):
    """(..., N, 8), (..., M, 8) corners → (..., N, M) areas."""
    ax = [a_cor[..., :, None, e] for e in range(4)]
    ay = [a_cor[..., :, None, 4 + e] for e in range(4)]
    bx = [b_cor[..., None, :, e] for e in range(4)]
    by = [b_cor[..., None, :, 4 + e] for e in range(4)]
    shape = torch.broadcast_shapes(ax[0].shape, bx[0].shape)
    zeros = a_cor.new_zeros(shape)
    px = [ax[i].expand(shape) if i < 4 else zeros for i in range(_CAP)]
    py = [ay[i].expand(shape) if i < 4 else zeros for i in range(_CAP)]
    n = torch.full(shape, 4, dtype=torch.int32, device=a_cor.device)
    for e in range(4):
        px, py, n = _clip_halfplane_slots(
            px, py, n, bx[e], by[e], bx[(e + 1) % 4], by[(e + 1) % 4])
    acc = zeros
    for i in range(_CAP):
        nxt_ok = (i + 1) < n
        j = (i + 1) % _CAP
        vnx = torch.where(nxt_ok, px[j], px[0])
        vny = torch.where(nxt_ok, py[j], py[0])
        acc = acc + torch.where(i < n, px[i] * vny - vnx * py[i], zeros)
    return 0.5 * torch.abs(acc)


def overlap_bev_plain(boxes_a, boxes_b):
    """Plain torch version: (..., N, 7), (..., M, 7) → (..., N, M)."""
    a_cor, b_cor = corners_cat(boxes_a), corners_cat(boxes_b)
    n = a_cor.shape[-2]
    if n <= _ROW_CHUNK:
        return _overlap_corners_plain(a_cor, b_cor)
    return torch.cat([_overlap_corners_plain(a_cor[..., r:r + _ROW_CHUNK, :],
                                             b_cor)
                      for r in range(0, n, _ROW_CHUNK)], dim=-2)


def boxes_overlap_bev_cuda(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) → (..., N, M) f32 rotated BEV overlap areas;
    leading (batch) dimensions must agree."""
    if boxes_a.device.type == 'cpu':
        return overlap_bev_plain(boxes_a, boxes_b)
    return _launch(boxes_a, boxes_b)


def _launch(boxes_a, boxes_b):
    global launches
    dev = boxes_a.device
    if dev.type != 'cuda' or boxes_b.device != dev:
        raise ValueError('overlap: both box tensors must be on one CUDA device')
    if boxes_a.shape[:-2] != boxes_b.shape[:-2] or boxes_a.shape[-1] < 7 \
            or boxes_b.shape[-1] < 7:
        raise ValueError(f'overlap: shapes {tuple(boxes_a.shape)}, '
                         f'{tuple(boxes_b.shape)}')
    if not (boxes_a.is_floating_point() and boxes_b.is_floating_point()):
        raise TypeError('overlap: boxes must be floating point')
    batch = boxes_a.shape[:-2]
    n, m = boxes_a.shape[-2], boxes_b.shape[-2]
    b = math.prod(batch)
    a_cor = corners_cat(boxes_a).reshape(b, n, 8)
    b_cor = corners_cat(boxes_b).reshape(b, m, 8)
    lib = cuda_build.load_library('overlap_bev', _SIG)
    out = torch.empty((b, n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.overlap_bev_launch(a_cor.data_ptr(), b_cor.data_ptr(),
                                     out.data_ptr(), b, n, m, stream)
    cuda_build.check(lib, 'overlap_bev', err)
    launches += 1
    return out.reshape(*batch, n, m)
