"""Rotated BEV overlap: wrappers of the CUDA kernels in ``csrc/overlap_bev.cu``.

Counterpart of ``crb_active_3ddet_tpu/ops/pallas_overlap.py:122
boxes_overlap_bev_pallas``: for (..., N, 7) × (..., M, 7) boxes, the area of
the intersection of every pair of rotated BEV rectangles.  A's 4 CCW corners
are clipped against B's 4 edges (Sutherland–Hodgman, ≤ 8 vertices), then the
shoelace area is taken.  Zero (degenerate) A boxes give 0.

Two entry points, each one launch for the whole batch on CUDA tensors (or a
raise), each taking raw boxes (the kernel computes the corners):
``boxes_overlap_bev_cuda`` gives the float matrix (``boxes_iou_bev``,
``boxes_iou3d``), and ``nms_mask`` gives the NMS's suppression matrix as
32-bit words, with the IoU, its threshold, the lower triangle and the alive
masks applied in the kernel, so no (K, K) float matrix is made.  On CPU
tensors each runs its plain version below (``overlap_bev_plain``, which
vectorises the same 8-slot clip over whole tensors, and ``nms_mask_plain``).
``launches`` and ``mask_launches`` count the two kernels' launches.
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
mask_launches = 0

_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG = {'overlap_bev_launch': [_PTR, _I64, _I64, _PTR, _I64, _I64, _PTR,
                               _INT, _INT, _INT, _PTR],
        'nms_mask_launch': [_PTR, _I64, _I64, _PTR, _INT, _INT, ctypes.c_float,
                            _PTR, _PTR, _PTR]}


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


def pack_bits(bits):
    """(..., n) bool → (..., ⌈n/32⌉) int32 words: bit b of word w is element
    32·w + b (bit 31 is the sign bit, which ``&`` and ``!= 0`` do not mind)."""
    n = bits.shape[-1]
    w = -(-n // 32)
    if w * 32 != n:
        bits = torch.cat([bits, bits.new_zeros(*bits.shape[:-1], w * 32 - n)], -1)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    words = bits.reshape(*bits.shape[:-1], w, 32).to(torch.int32) << shifts
    return words.sum(-1, dtype=torch.int32)      # disjoint bits: the sum is the OR


def mask_from_overlap(overlap, boxes, alive, thresh: float):
    """Suppression words from the (..., K, K) overlap of ``boxes`` with
    themselves: bit j of row i is set iff j < i, both alive and
    iou(i, j) > thresh (``crb_active_3ddet_tpu/ops/nms.py:205-220``)."""
    areas = boxes[..., 3] * boxes[..., 4]
    iou = overlap / torch.clamp(areas[..., :, None] + areas[..., None, :]
                                - overlap, min=_EPS)
    idx = torch.arange(boxes.shape[-2], device=boxes.device)
    return pack_bits((iou > thresh) & (idx[None, :] < idx[:, None])
                     & alive[..., None, :] & alive[..., :, None])


def nms_mask_plain(boxes, alive, thresh: float):
    """Plain torch version of the mask entry: (..., K, 7+), (..., K) bool →
    (..., K, ⌈K/32⌉) int32, every pair clipped."""
    return mask_from_overlap(overlap_bev_plain(boxes, boxes), boxes, alive, thresh)


def boxes_overlap_bev_cuda(boxes_a, boxes_b):
    """(..., N, 7+), (..., M, 7+) → (..., N, M) f32 rotated BEV overlap
    areas; leading (batch) dimensions must agree."""
    if boxes_a.device.type == 'cpu':
        return overlap_bev_plain(boxes_a, boxes_b)
    return _launch(boxes_a, boxes_b)


def nms_mask(boxes, alive, thresh: float):
    """boxes (..., K, 7+) f32, alive (..., K) bool → (..., K, ⌈K/32⌉) int32
    suppression words of the NMS, as ``nms_mask_plain`` gives them."""
    if boxes.device.type == 'cpu':
        return nms_mask_plain(boxes, alive, thresh)
    return _launch_mask(boxes, alive, thresh)


def _check_boxes(what, dev, *boxes):
    if dev.type != 'cuda' or any(t.device != dev for t in boxes):
        raise ValueError(f'{what}: tensors must be on one CUDA device')
    for t in boxes:
        if t.ndim < 2 or t.shape[-1] < 7:
            raise ValueError(f'{what}: boxes of shape {tuple(t.shape)}, want (..., N, 7+)')
        if t.dtype != torch.float32:
            raise TypeError(f'{what}: boxes must be float32, got {t.dtype}')


def _rows(boxes, b):
    """(..., N, C) → a (b, N, C) view (or copy) whose last dimension is
    contiguous, as the kernels read it."""
    flat = boxes.reshape(b, *boxes.shape[-2:])
    return flat if flat.stride(-1) == 1 else flat.contiguous()


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _launch(boxes_a, boxes_b):
    global launches
    dev = boxes_a.device
    _check_boxes('overlap', dev, boxes_a, boxes_b)
    if boxes_a.shape[:-2] != boxes_b.shape[:-2]:
        raise ValueError(f'overlap: shapes {tuple(boxes_a.shape)}, '
                         f'{tuple(boxes_b.shape)}')
    batch = boxes_a.shape[:-2]
    n, m = boxes_a.shape[-2], boxes_b.shape[-2]
    b = math.prod(batch)
    a, bb = _rows(boxes_a, b), _rows(boxes_b, b)
    lib = cuda_build.load_library('overlap_bev', _SIG)
    out = torch.empty((b, n, m), dtype=torch.float32, device=dev)
    err = lib.overlap_bev_launch(a.data_ptr(), a.stride(0), a.stride(1),
                                 bb.data_ptr(), bb.stride(0), bb.stride(1),
                                 out.data_ptr(), b, n, m, _stream(dev))
    cuda_build.check(lib, 'overlap_bev', err)
    launches += 1
    return out.reshape(*batch, n, m)


def _launch_mask(boxes, alive, thresh):
    global mask_launches
    dev = boxes.device
    _check_boxes('nms_mask', dev, boxes)
    if alive.device != dev or alive.dtype != torch.bool \
            or alive.shape != boxes.shape[:-1]:
        raise ValueError(f'nms_mask: alive {alive.dtype} {tuple(alive.shape)} on '
                         f'{alive.device} for boxes {tuple(boxes.shape)}')
    batch, k = boxes.shape[:-2], boxes.shape[-2]
    b, w = math.prod(batch), -(-k // 32)
    flat = _rows(boxes, b)
    alive = alive.reshape(b, k).contiguous()
    lib = cuda_build.load_library('overlap_bev', _SIG)
    words = torch.empty((b, k, w), dtype=torch.int32, device=dev)
    err = lib.nms_mask_launch(flat.data_ptr(), flat.stride(0), flat.stride(1),
                              alive.data_ptr(), b, k, float(thresh),
                              words.data_ptr(), None, _stream(dev))
    cuda_build.check(lib, 'overlap_bev', err)
    mask_launches += 1
    return words.reshape(*batch, k, w)
