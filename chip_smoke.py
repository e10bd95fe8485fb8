"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It
  1. prints the card's name and power limit and builds the hand-written CUDA
     kernels (one nvcc per source, started together);
  2. drives the port's eval step (``make_eval_step``) for two detectors, each
     at the full width of its config, batch 8, from seeded random weights:
     SECOND (tools/cfgs/synthetic_models/second_synth.yaml) and PV-RCNN
     (pv_rcnn_synth.yaml), with every kernel launch counter set to 0 just
     before each step and read just after, and records each kernel call's
     inputs;
  3. times each step, each of its stages, and one step under torch.profiler
     (kernel launches, host syncs, device time, busy share);
  4. checks the outputs: the same batch on the plain PyTorch versions (on the
     card) against the kernel path, at the 3D backbone's output, the BEV
     features, the head's raw outputs and the decoded pre-NMS predictions;
     for PV-RCNN also the keypoints (equal), the point features, the point
     head's outputs, and the RoI stage run from one common set of RoIs;
  5. holds each kernel against its plain version on the card at the inputs
     each path gave it (the gather-GEMM at all 12 sparse-conv layers, bf16,
     with the share of each layer's rulebook that is empty; the overlap's
     NMS mask at every NMS, bit for bit but for pairs within 1e-6 of the
     threshold, which it counts, with the share of the lower-triangle live
     pairs that reached the clip and the fixpoint's rounds, and its float
     matrix at each recall record, with degenerate rows; the farthest point
     sampling at (8, 18000) -> 1024 and at other shapes from one point to
     the kernel's capacity, with ties, few and no valid points, for
     equality), and times kernel, plain version and library yardstick with
     CUDA events (a kernel shorter than its call's host time by replaying a
     CUDA graph of calls); the NMS mask also at its worst case (every box at
     one point) and on pairs that nearly touch;
  6. drives SECOND's train step (``make_train_step``) at full width, batch
     8, on the train split: launches per step (12 gather-GEMM forward, 11
     dgrad, 12 wgrad), ms/step and samples/s, the stages, a profiled step,
     the kernel path against the plain path (loss terms and every
     parameter's gradient, bf16 and f32), and the dgrad and wgrad against
     their plain versions at every layer's inputs, with their timings (the
     wgrad on the route the step ran, tensor cores in bf16, and on its f32
     route with the same numbers);
  7. runs a reduced SECOND and a reduced PV-RCNN in f32 on the card against
     the CPU path (which the CPU tests hold against the JAX reference),
     predictions and recall record, and a reduced SECOND train step (loss
     terms, gradients, updated parameters, BN statistics).
Any failed check raises.  The last line is the device JSON; the line before
it holds the per-kernel measurements.  Exits non-zero without a CUDA card.

    python3 chip_smoke.py --ablate-k2

instead times, at each sparse conv layer of the SECOND step, measurement
builds of the gather-GEMM with its row gather, its weight reads or both
compiled out: where that kernel's time goes, on a machine without a profiler
for single kernels.

    python3 chip_smoke.py --ablate-wgrad

likewise times the bf16 weight gradient's tensor-core kernel at each layer
of the SECOND train step with its row gather, its mmas or both compiled out.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# cuBLAS keeps to one order of summation under torch's deterministic
# algorithms (the train phase's kernel-vs-plain check) only with this set
# before its first call
os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
MEM_BW = 3.35e12                     # H100 SXM HBM3 bytes/s
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense FLOP/s
OVERLAP_OPS_PER_PAIR = 440           # f32 ops of the 8-slot clip, per pair
MARGIN = 1e-2                        # m, the overlap kernel's early-out margin
FPS_OPS_PER_POINT_STEP = 10          # 3 sub, 3 mul, 2 add, 1 min, 1 compare
BATCH = 8
SECOND_CFG = 'tools/cfgs/synthetic_models/second_synth.yaml'
PVRCNN_CFG = 'tools/cfgs/synthetic_models/pv_rcnn_synth.yaml'
# conv_cls bias of the seeded models: about 40 % of SECOND's anchors then
# score above SCORE_THRESH 0.1, so its NMS runs at its full MATRIX_CAP width
# (PV-RCNN's proposal NMS has no threshold and always runs 1024 boxes)
CLS_BIAS = -2.26
# kernel path vs plain path, bf16 main path: max |diff| / (1 + |ref|).  The
# two paths feed K2 the same operands and differ only in its f32 summation
# order; a changed sum rounds to another bf16 value at the next layer's
# input cast, which the later layers carry on.  Limits are 3-5x the
# readings on an H100 80GB HBM3 at 700 W (PERF.md, Findings).
E2E_TOL = {'encoded_spconv_features': 1e-3, 'spatial_features_2d': 5e-3,
           'cls_preds': 1e-3, 'box_preds': 2e-3, 'dir_cls_preds': 2e-3,
           'batch_box_preds': 5e-3}
# PV-RCNN's point branch reads the backbone's f32 stage outputs and BEV map;
# the RoI stage is run from common RoIs.  With K2's sums on tensor cores in
# every layer, conv_input included, the stage outputs carry the same rounded-
# to-another-bf16-value differences as the tensors above.  Limits are 4-9x the
# readings (1.3e-3, 1.9e-4, 2.1e-5, 1.1e-7, 2.4e-7 in this order; PERF.md).
POINT_TOL = {'point_features_before_fusion': 5e-3, 'point_features': 8e-4,
             'point_cls_preds': 1e-4, 'rcnn_cls': 1e-6, 'rcnn_reg': 1e-6}
# train step, kernel path vs plain path (both on the card, one step from the
# seeded weights and the first batch, with torch's deterministic algorithms
# on, each path run twice and its own spread printed): each loss term |diff|/|ref|; each
# parameter's gradient ||diff||/||ref||, the largest ('grad') and the median
# over the parameters, and the least cosine of the two gradients ('cos': a
# zero or sign-flipped gradient fails it).
# bf16 (the config): the two paths feed the kernels the same operands and
# differ in f32 summation order, which each layer's bf16 cast turns into
# other bf16 values, forward and backward.  This randomly initialised model
# carries rounding differences into its gradients some thousand-fold, most
# in the BatchNorm biases (sums over every voxel or pixel that nearly
# cancel): in bf16 the gradients lie tens of per cent apart in norm, so the
# bf16 gate is the cosine and the median, not the largest norm.  The CPU
# tests find the same bf16 spread between the JAX and the port's gradients
# and an f64 step; each kernel is held tightly at its own inputs below.
# Readings on an H100 80GB HBM3 at 700 W (PERF.md, Findings), each path's
# own spread 0: bf16 loss terms 8.2e-4, median 0.221, least cosine 0.930
# (largest 0.368); f32 loss terms 1.1e-7, largest 5.0e-3, median 1.7e-3.
# Limits are 3.4-4x them (for the cosine, 3.6x its distance from 1), but
# the f32 losses' 1e-6: they read 0 to three rounding steps of the sum,
# below which no multiple means much.
TRAIN_TOL = {'bf16': {'loss': 3e-3, 'cos': 0.75, 'median': 0.75},
             'f32': {'loss': 1e-6, 'grad': 2e-2, 'median': 6e-3}}
TRAIN_LOSSES = ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss')
SPARSE_LAYERS = ['conv_input', 'conv1.0', 'conv2.0', 'conv2.1', 'conv2.2',
                 'conv3.0', 'conv3.1', 'conv3.2', 'conv4.0', 'conv4.1',
                 'conv4.2', 'conv_out']
# (N, K, valid) of the small FPS checks; the first three are those of the JAX
# package's own parity test
FPS_SMALL = [(300, 32, 300), (1024, 256, 640), (129, 64, 129),
             (64, 100, 5), (64, 16, 0), (1, 4, 1), (2049, 64, 2049),
             ('capacity', 48, 'capacity')]


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters=20, replays=5):
    """Device time of one ``fn()``: ``iters`` calls captured into a CUDA graph
    and replayed, so the host's part of a call (allocation, checks, launch)
    is not timed.  ``cuda_time_ms`` of a call that is shorter on the card
    than on the host reads the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return cuda_time_ms(graph.replay, warmup=1, iters=replays) / iters


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions (on the
    card) — the comparison baseline; the port itself has no such switch.
    The sparse conv's autograd Function looks its three wrappers up at call
    time, so the backward goes plain too."""
    from crb_active_3ddet_torch.ops import (cuda_fps, cuda_kernels, cuda_overlap, iou3d,
                                            nms, pointnet2)
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import (
        gather_gemm_dgrad_plain, gather_gemm_wgrad_plain, subm_conv3d_gather)
    saved = (cuda_kernels.sparse_conv_gather_gemm, cuda_kernels.gather_gemm_dgrad,
             cuda_kernels.gather_gemm_wgrad, iou3d.boxes_overlap_bev_cuda,
             nms.nms_mask, pointnet2.farthest_point_sample_cuda)
    cuda_kernels.sparse_conv_gather_gemm = subm_conv3d_gather
    cuda_kernels.gather_gemm_dgrad = (lambda dout, rbk, inv, w, v_in:
                                      gather_gemm_dgrad_plain(dout, rbk, w, v_in))
    cuda_kernels.gather_gemm_wgrad = (lambda feats, rbk, dout, rbk_t=None:
                                      gather_gemm_wgrad_plain(feats, rbk, dout))
    iou3d.boxes_overlap_bev_cuda = cuda_overlap.overlap_bev_plain
    nms.nms_mask = cuda_overlap.nms_mask_plain
    pointnet2.farthest_point_sample_cuda = cuda_fps.fps_plain
    try:
        yield
    finally:
        (cuda_kernels.sparse_conv_gather_gemm, cuda_kernels.gather_gemm_dgrad,
         cuda_kernels.gather_gemm_wgrad, iou3d.boxes_overlap_bev_cuda,
         nms.nms_mask, pointnet2.farthest_point_sample_cuda) = saved


@contextlib.contextmanager
def recording(caller, attr, calls, count=lambda: 0):
    """Append (args, launches, result) of every call ``caller.attr`` makes
    to calls; ``count()`` reads the launch counter of the kernel behind it."""
    real = getattr(caller, attr)

    def record(*args):
        before = count()
        out = real(*args)
        calls.append((args, count() - before, out))
        return out
    setattr(caller, attr, record)
    try:
        yield
    finally:
        setattr(caller, attr, real)


def stage_ms(model, dataset, batch, post_cfg, num_class, iters=3):
    """Host-clock time of each stage of one eval step, synchronised at the
    stage boundaries (so it includes each stage's launch overhead)."""
    from crb_active_3ddet_torch.models import post_processing as pp
    from crb_active_3ddet_torch.runtime.train import prepare_device_batch
    totals = {}

    def timed(name, fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        totals[name] = totals.get(name, 0.0) + (time.perf_counter() - t) * 1e3 / iters
        return out

    with torch.no_grad():
        for _ in range(iters):
            d = timed('voxelize', prepare_device_batch, batch, dataset.voxel_cfg,
                      dataset.grid_size, dataset.point_cloud_range,
                      dataset.voxel_size)
            d = dict(d)
            for name in model.module_topology:
                d = timed(name, getattr(model, name), d)
            preds = timed('post_processing', pp.post_processing, d, post_cfg,
                          num_class)
            gt = d['gt_boxes']
            timed('recall record', pp.generate_recall_record, preds['pred_boxes'],
                  preds['pred_valid'], gt[..., :7], torch.abs(gt).sum(-1) > 0)
    return totals


def profile_step(step, batch, rows=10):
    """Trace one warm step with torch.profiler and print its summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in events if 'LaunchKernel' in e.key)
    syncs = sum(e.count for e in events if e.key == 'cudaStreamSynchronize')
    log(f'profiled step: wall {wall_ms:.2f} ms (under the profiler), kernel '
        f'device time {device_ms:.2f} ms, busy share <= {device_ms / wall_ms:.3f}, '
        f'kernel launches {launches}, stream synchronisations {syncs}')
    ours = {}
    for e in events:
        name = next((k for k in ('gather_mma_kernel', 'gather_fma_kernel',
                                 'pack_weights_kernel', 'wgrad_partial_kernel',
                                 'wgrad_mma_kernel',
                                 'sum_slices_kernel', 'fps_kernel',
                                 'overlap_bev_kernel', 'nms_mask_kernel')
                     if k in e.key), None)
        if name and e.device_type == DeviceType.CUDA:
            n, ms = ours.get(name, (0, 0.0))
            ours[name] = (n + e.count, ms + e.self_device_time_total / 1e3)
    log('hand-written kernels in the profiled step (launches, device ms): '
        + ', '.join(f'{k} {n} x, {ms:.4f}' for k, (n, ms) in sorted(ours.items())))
    log(events.table(sort_by='self_device_time_total', row_limit=rows,
                     max_name_column_width=60))


def ptxas_entries(report):
    """(kernel<template arguments>, registers, static shared bytes, spill
    bytes stored+loaded) of every entry function in an nvcc -Xptxas -v report."""
    entries = []
    for block in report.split('Compiling entry function ')[1:]:
        mangled = block.split("'")[1]
        kernel = re.search(r'\d+([a-z_]+_kernel)(?:I(.*?)EEv)?', mangled)
        args = re.findall(r'Li(\d+)|(f)|__nv_(bfloat16)', kernel.group(2) or '')
        regs = re.search(r'Used (\d+) registers', block)
        smem = re.search(r'(\d+) bytes smem', block)
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', block)
        entries.append((
            kernel.group(1) + '<' + ', '.join(next(x for x in a if x) for a in args) + '>',
            int(regs.group(1)) if regs else -1, int(smem.group(1)) if smem else 0,
            int(spill.group(1)) + int(spill.group(2)) if spill else -1))
    return entries


def reduced_cfg(cfg):
    """Reduced SECOND or PV-RCNN (grid 128×128×40, narrow BEV and point
    branch, f32) for the CPU/card check."""
    d = cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [0, -3.2, -3, 6.4, 3.2, 1]
    d.NUM_SCENES, d.NUM_BG_POINTS, d.MAX_OBJECTS = 4, 1200, 4
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    m = cfg.MODEL
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256     # 1536 anchors/frame
    m.BACKBONE_3D.USE_BF16 = m.BACKBONE_2D.USE_BF16 = False
    m.BACKBONE_3D.VOXEL_CAPS = [384, 256, 128, 128]
    m.BACKBONE_2D.LAYER_NUMS, m.BACKBONE_2D.NUM_FILTERS = [1, 1], [16, 32]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    if m.get('PFE', None) is not None:
        m.PFE.NUM_KEYPOINTS, m.PFE.NUM_OUTPUT_FEATURES = 256, 32
        for layer in m.PFE.SA_LAYER.values():
            layer.MLPS, layer.NSAMPLE = [[8, 8], [8, 8]], [8, 8]
        m.POINT_HEAD.CLS_FC = [32, 32]
        r = m.ROI_HEAD
        r.SHARED_FC, r.CLS_FC, r.REG_FC = [64, 64], [32, 32], [32, 32]
        r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 256
        r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 32
        r.ROI_GRID_POOL.GRID_SIZE = 4
        r.ROI_GRID_POOL.MLPS, r.ROI_GRID_POOL.NSAMPLE = [[16, 16], [16, 16]], [8, 8]
    return cfg


def build(cfg, batch_size, device, seed, cls_bias):
    from crb_active_3ddet_torch.datasets import build_dataloader
    from crb_active_3ddet_torch.models.detectors import build_detector, init_weights
    from crb_active_3ddet_torch.runtime.eval import make_eval_step
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                          batch_size, workers=0, training=False)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device='cpu')
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.dense_head.conv_cls.bias.fill_(cls_bias)
    model = model.to(device)
    step = make_eval_step(model, dataset, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    return dataset, loader, model, step


def rel_err(a, b, heading=False):
    """max |a − b| / (1 + |b|) and max |a − b|; box headings modulo π."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    if heading:
        dh = (a[..., 6] - b[..., 6]).remainder(np.pi)
        d[..., 6] = torch.minimum(dh, np.pi - dh)
    return (d / (1 + b.abs())).max().item(), d.max().item()


def check_kernel_path(model, vox):
    """The same batch through the plain versions on the card, held against
    the kernel path before any NMS.  Continuous tensors are compared as they
    are; the decoded boxes' heading modulo π, since a direction-bin argmax
    between two near-equal logits moves it by exactly π — each such flip
    must be a near-tie within the dir logits' own difference.  PV-RCNN: the
    keypoints must be equal (the FPS is exact); the RoI stage is run on both
    paths' point features from the kernel path's RoIs, because a near-tie in
    the proposal NMS may pick other RoIs, after which nothing compares."""
    two_stage = hasattr(model, 'roi_head')
    with torch.no_grad():
        out = model(vox)
        with plain_versions():
            ref = model(vox)
        if two_stage:
            keys = ('point_coords', 'point_coords_valid', 'point_features',
                    'point_cls_scores')
            same_rois = torch.equal(out['rois'], ref['rois'])
            roi_ref = model.roi_head({**{k: ref[k] for k in keys},
                                      'rois': out['rois']})
            ref = {**ref, 'rcnn_cls': roi_ref['rcnn_cls'],
                   'rcnn_reg': roi_ref['rcnn_reg']}
    tols = dict(E2E_TOL)
    if two_stage:
        for k in ('point_coords', 'point_coords_valid'):
            if not torch.equal(out[k], ref[k]):
                raise RuntimeError(f'kernel path vs plain path: {k} differs')
        log(f'kernel path vs plain: keypoints equal; RoI sets equal: {same_rois}')
        tols.update(POINT_TOL)
        del tols['batch_box_preds']       # the roi head's: other RoIs on ref
    errs, diffs = {}, {}
    for key in tols:
        errs[key], diffs[key] = rel_err(out[key], ref[key],
                                        heading=key == 'batch_box_preds')
        log(f'kernel path vs plain, {key} {tuple(ref[key].shape)}: max |diff|/(1+|ref|) '
            f'= {errs[key]:.3e} (tol {tols[key]:.0e}), max |diff| {diffs[key]:.3e}')
    nb = model.dense_head.model_cfg['NUM_DIR_BINS']
    da = out['dir_cls_preds'].reshape(BATCH, -1, nb).float()
    db = ref['dir_cls_preds'].reshape(BATCH, -1, nb).float()
    flip = da.argmax(-1) != db.argmax(-1)
    top2 = db.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1])[flip]
    worst_gap = gap.max().item() if gap.numel() else 0.0
    log(f'direction-bin flips kernel vs plain: {int(flip.sum())} of {flip.numel()} '
        f'anchors, largest reference logit gap among them {worst_gap:.3e} '
        f'(must be <= 2 x max |diff| of dir_cls_preds = {2 * diffs["dir_cls_preds"]:.3e})')
    bad = [k for k in tols if not errs[k] <= tols[k]]
    if bad:
        raise RuntimeError(f'kernel path disagrees with the plain path at {bad}')
    if not worst_gap <= 2 * diffs['dir_cls_preds']:
        raise RuntimeError('a direction-bin flip is not a near-tie')
    return out


def _entry(name, source, replaces, n_launch, err, ms, plain_ms, nbytes, ops,
           peak, library_ms=None):
    """One kernel's entry of the JSON line; the bound from this run's bytes
    and operations."""
    t_bytes, t_ops = nbytes / MEM_BW, ops / peak
    return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
            'launches': n_launch, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops) * 1e3,
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': library_ms}


K1_SOURCE = 'crb_active_3ddet_torch/csrc/overlap_bev.cu'
K1_REPLACES = 'crb_active_3ddet_tpu/ops/pallas_overlap.py:122'


def time_overlap(name, a, b, n_launch, tag):
    """Hold the overlap kernel's float entry against its plain version on
    (a, b) as the path gave them; time the call, the bare launch and the
    plain version; return the kernel's JSON entry."""
    from crb_active_3ddet_torch.ops import cuda_build, cuda_overlap
    got = cuda_overlap.boxes_overlap_bev_cuda(a, b)
    ref = cuda_overlap.overlap_bev_plain(a, b)
    err = (got - ref).abs().max().item()
    if not err <= 1e-4:
        raise RuntimeError(f'overlap {tag}: max err {err} > 1e-4')
    zero = (a == 0).all(-1)
    if not (got[zero] == 0).all():
        raise RuntimeError(f'overlap {tag}: degenerate rows give non-zero areas')
    ms = cuda_time_ms(lambda: cuda_overlap.boxes_overlap_bev_cuda(a, b))
    plain_ms = cuda_time_ms(lambda: cuda_overlap.overlap_bev_plain(a, b),
                            warmup=1, iters=3)
    bsz, n, m = got.shape
    lib = cuda_build.load_library('overlap_bev', cuda_overlap._SIG)
    fa, fb = cuda_overlap._rows(a, bsz), cuda_overlap._rows(b, bsz)
    out = torch.empty_like(got)
    bare_ms = graph_time_ms(lambda: lib.overlap_bev_launch(
        fa.data_ptr(), fa.stride(0), fa.stride(1), fb.data_ptr(), fb.stride(0),
        fb.stride(1), out.data_ptr(), bsz, n, m, torch.cuda.current_stream().cuda_stream))
    if not torch.equal(out, got):
        raise RuntimeError(f'overlap {tag}: the bare launch differs from the wrapper')
    nbytes = (a[..., :7].numel() + b[..., :7].numel() + bsz * n * m) * 4
    n_clip = pairs_to_clip(a, b)
    entry = _entry(name, K1_SOURCE, K1_REPLACES, n_launch, err, ms, plain_ms,
                   nbytes, n_clip * OVERLAP_OPS_PER_PAIR, PEAK[torch.float32])
    bound_all = max(nbytes / MEM_BW,
                    bsz * n * m * OVERLAP_OPS_PER_PAIR / PEAK[torch.float32]) * 1e3
    log(f'overlap_bev {tag} ({bsz}, {n}, {m}), float entry: err {err:.2e} (tol '
        f'1e-4), max |ref| {ref.abs().max().item():.3f}, {int(zero.sum())} '
        f'degenerate rows give 0; whole call {ms:.4f} ms, bare kernel '
        f'{bare_ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms; {n_clip} of '
        f'{bsz * n * m} pairs need the clip; bound {entry["bound_ms"]:.5f} ms '
        f'({entry["bound_by"]}) over those, {bound_all:.5f} ms over every pair')
    return entry


def pairs_to_clip(a, b):
    """Pairs of (a, b) whose overlap needs the clip: both boxes of non-zero
    area and corner bounds within MARGIN of each other.  Any other pair's
    overlap follows from one test (bounds apart or a point A: 0; a point B:
    area(A)), so the kernel's bound counts the clip's operations only here."""
    from crb_active_3ddet_torch.ops import cuda_overlap
    ca, cb = cuda_overlap.corners_cat(a[..., :7]), cuda_overlap.corners_cat(b[..., :7])

    def bounds(c):
        return (c[..., :4].amin(-1), c[..., :4].amax(-1),
                c[..., 4:].amin(-1), c[..., 4:].amax(-1))
    (ax0, ax1, ay0, ay1), (bx0, bx1, by0, by1) = bounds(ca), bounds(cb)
    near = ~((ax0[..., :, None] - bx1[..., None, :] > MARGIN)
             | (bx0[..., None, :] - ax1[..., :, None] > MARGIN)
             | (ay0[..., :, None] - by1[..., None, :] > MARGIN)
             | (by0[..., None, :] - ay1[..., :, None] > MARGIN))
    solid_a, solid_b = a[..., 3] * a[..., 4] > 0, b[..., 3] * b[..., 4] > 0
    return int((near & solid_a[..., :, None] & solid_b[..., None, :]).sum())


def unpack_words(words, k):
    """(..., W) int32 words → (..., k) bool on the device."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).bool().flatten(-2)[..., :k]


def mask_vs_plain(words, boxes, alive, thresh, tag):
    """The mask kernel's words against the plain words on the same inputs:
    equal but for pairs whose plain IoU lies within 1e-6 of the threshold.
    Returns (bits that differ, such pairs among those the NMS reads)."""
    from crb_active_3ddet_torch.ops import cuda_overlap
    k = boxes.shape[-2]
    ov = cuda_overlap.overlap_bev_plain(boxes, boxes)
    ref = cuda_overlap.mask_from_overlap(ov, boxes, alive, thresh)
    areas = boxes[..., 3] * boxes[..., 4]
    iou = ov / torch.clamp(areas[..., :, None] + areas[..., None, :] - ov, min=1e-8)
    lower = torch.ones(k, k, dtype=torch.bool, device=boxes.device).tril(-1)
    read = lower & alive[..., :, None] & alive[..., None, :]
    near = read & ((iou - thresh).abs() <= 1e-6)
    diff = unpack_words(words ^ ref, k)
    wrong = int((diff & ~near).sum())
    if wrong:
        raise RuntimeError(f'nms_mask {tag}: {wrong} bits differ from the plain '
                           f'version away from the threshold')
    return int(diff.sum()), int(near.sum())


def bare_mask(boxes, alive, thresh, words, clipped=None):
    """One launch of the mask kernel straight from its C entry point."""
    from crb_active_3ddet_torch.ops import cuda_build, cuda_overlap
    lib = cuda_build.load_library('overlap_bev', cuda_overlap._SIG)
    b, k = alive.shape
    cuda_build.check(lib, 'overlap_bev', lib.nms_mask_launch(
        boxes.data_ptr(), boxes.stride(0), boxes.stride(1), alive.data_ptr(), b, k,
        thresh, words.data_ptr(), None if clipped is None else clipped.data_ptr(),
        torch.cuda.current_stream().cuda_stream))


def clipped_pairs(boxes, alive, thresh):
    """(pairs the mask kernel clipped, lower-triangle live pairs)."""
    words = torch.empty(*alive.shape, -(-alive.shape[1] // 32), dtype=torch.int32,
                        device=boxes.device)
    clipped = torch.zeros(1, dtype=torch.int64, device=boxes.device)
    bare_mask(boxes, alive, thresh, words, clipped)
    a = alive.sum(-1)
    return int(clipped.item()), int((a * (a - 1) // 2).sum())


def time_mask(name, boxes, alive, thresh, n_launch, rounds, tag):
    """Hold the mask kernel against its plain version at one NMS's inputs;
    time the call, the bare kernel, the plain version, the route through the
    float matrix and the fixpoint; return the kernel's JSON entry."""
    from crb_active_3ddet_torch.ops import cuda_overlap, nms
    boxes, alive = boxes.contiguous(), alive.contiguous()
    words = cuda_overlap.nms_mask(boxes, alive, thresh)
    differ, near = mask_vs_plain(words, boxes, alive, thresh, tag)
    n_clip, n_lower = clipped_pairs(boxes, alive, thresh)
    out = torch.empty_like(words)
    bare_ms = graph_time_ms(lambda: bare_mask(boxes, alive, thresh, out))
    if not torch.equal(out, words):
        raise RuntimeError(f'nms_mask {tag}: the bare launch differs from the wrapper')
    ms = cuda_time_ms(lambda: cuda_overlap.nms_mask(boxes, alive, thresh))
    plain_ms = cuda_time_ms(lambda: cuda_overlap.nms_mask_plain(boxes, alive, thresh),
                            warmup=1, iters=3)
    float_ms = cuda_time_ms(lambda: cuda_overlap.mask_from_overlap(
        cuda_overlap.boxes_overlap_bev_cuda(boxes, boxes), boxes, alive, thresh))
    fixpoint_ms = cuda_time_ms(lambda: nms._fixpoint_words(words, 32), iters=5)
    b, k = alive.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nms._fixpoint_words(cuda_overlap.nms_mask(boxes, alive, thresh), 32)
    peak = torch.cuda.max_memory_allocated() - base
    if peak >= b * k * k * 4:
        raise RuntimeError(f'nms_mask {tag}: mask and fixpoint took {peak} bytes, '
                           f'as much as a ({b}, {k}, {k}) float matrix')
    nbytes = boxes.numel() * 4 + alive.numel() + words.numel() * 4
    ops_all = b * k * (k - 1) // 2 * OVERLAP_OPS_PER_PAIR
    entry = _entry(name, K1_SOURCE, K1_REPLACES, n_launch, float(differ > 0), ms,
                   plain_ms, nbytes, n_clip * OVERLAP_OPS_PER_PAIR, PEAK[torch.float32])
    bound_all = max(nbytes / MEM_BW, ops_all / PEAK[torch.float32]) * 1e3
    log(f'nms_mask {tag} ({b}, {k}), thresh {thresh}: {differ} bits differ from the '
        f'plain words, {near} read pairs within 1e-6 of the threshold; clipped '
        f'{n_clip} of {n_lower} lower-triangle live pairs '
        f'({n_clip / max(1, n_lower):.4f}); fixpoint rounds {rounds}; whole call '
        f'{ms:.4f} ms, bare kernel {bare_ms:.4f} ms (graph replay), plain '
        f'{plain_ms:.4f} ms, float matrix + torch ops {float_ms:.4f} ms, fixpoint '
        f'{fixpoint_ms:.4f} ms; bound {entry["bound_ms"]:.4f} ms over the clipped '
        f'pairs, {bound_all:.4f} ms over all K(K-1)/2 pairs; peak device memory of '
        f'mask + fixpoint {peak / 2**20:.2f} MiB (a float (B, K, K) matrix: '
        f'{b * k * k * 4 / 2**20:.2f} MiB)')
    return entry


def near_touching(rng, k, margin, reach=60.0):
    """k boxes (k even) in pairs whose corner bounds lie 0 to 2 × margin
    apart along x or y (either side; the other axis overlapping), centres
    within ±reach m (made on the CPU)."""
    from crb_active_3ddet_torch.ops import cuda_overlap
    half = k // 2
    a, b = np.zeros((half, 7), np.float32), np.zeros((half, 7), np.float32)
    for box in (a, b):
        box[:, 3:6] = rng.uniform(0.5, 5.0, (half, 3))
        box[:, 6] = rng.uniform(-np.pi, np.pi, half)
    a[:, :2] = rng.uniform(-reach, reach, (half, 2))
    ac = cuda_overlap.corners_cat(torch.from_numpy(a)).numpy()
    bc = cuda_overlap.corners_cat(torch.from_numpy(b)).numpy()
    ax0, ax1, ay0, ay1 = ac[:, :4].min(1), ac[:, :4].max(1), ac[:, 4:].min(1), ac[:, 4:].max(1)
    bx0, bx1, by0, by1 = bc[:, :4].min(1), bc[:, :4].max(1), bc[:, 4:].min(1), bc[:, 4:].max(1)
    gap = np.linspace(0, 2 * margin, half).astype(np.float32)
    side = np.arange(half) % 4
    along = rng.uniform(0, 1, half).astype(np.float32)
    b[:, 0] = np.where(side == 0, ax1 + gap - bx0, np.where(
        side == 1, ax0 - gap - bx1, ax0 + along * (ax1 - ax0)))
    b[:, 1] = np.where(side == 2, ay1 + gap - by0, np.where(
        side == 3, ay0 - gap - by1, ay0 + along * (ay1 - ay0)))
    return np.stack([a, b], 1).reshape(k, 7)


def mask_stress(dev, k=1024):
    """The mask kernel at (8, k) on its worst case (every box at one point:
    every pair is clipped; threshold 0.1) and on pairs that nearly touch
    (corner bounds 0 to 2 × the early-out's margin apart; threshold 0, so
    that any area a skipped pair should have had would show), against the
    plain words."""
    from crb_active_3ddet_torch.ops import cuda_overlap
    rng = np.random.RandomState(7)
    point = np.zeros((BATCH, k, 7), np.float32)
    point[..., :2] = 3.0
    point[..., 3:6] = rng.uniform(0.5, 5.0, (BATCH, k, 3))
    point[..., 6] = rng.uniform(-np.pi, np.pi, (BATCH, k))
    touch = np.stack([near_touching(rng, k, MARGIN) for _ in range(BATCH)])
    alive = torch.ones(BATCH, k, dtype=torch.bool, device=dev)
    for tag, boxes, thresh in (('every box at one point', point, 0.1),
                               ('near-touching pairs', touch, 0.0)):
        boxes = torch.from_numpy(boxes).to(dev)
        words = cuda_overlap.nms_mask(boxes, alive, thresh)
        differ, near = mask_vs_plain(words, boxes, alive, thresh, tag)
        if thresh == 0.0 and differ:    # every zero IoU lies "within 1e-6" of 0
            raise RuntimeError(f'nms_mask {tag}: {differ} bits differ at threshold 0')
        n_clip, n_lower = clipped_pairs(boxes, alive, thresh)
        out = torch.empty_like(words)
        bare_ms = graph_time_ms(lambda: bare_mask(boxes, alive, thresh, out))
        excused = ('none excused at threshold 0' if thresh == 0.0 else
                   f'{near} pairs within 1e-6 of the threshold')
        log(f'nms_mask {tag} ({BATCH}, {k}), thresh {thresh}: {differ} bits differ '
            f'from the plain words, {excused}; clipped {n_clip} of '
            f'{n_lower} ({n_clip / n_lower:.4f}); bare kernel {bare_ms:.4f} ms '
            f'(graph replay); bound over the clipped pairs '
            f'{n_clip * OVERLAP_OPS_PER_PAIR / PEAK[torch.float32] * 1e3:.4f} ms')


def rulebook_emptiness(name, rbk):
    """Log what share of a layer's rulebook a gather-GEMM can skip, at the
    granularity of an entry, of a (16-row group, offset) pair and of a
    (64-row tile, offset) pair; 'live' counts only groups or tiles that hold
    at least one hit (the others are the buffers' padding rows)."""
    hit = rbk >= 0
    v, k = hit.shape
    parts = [f'{name}: entries that hit {hit.float().mean().item():.4f}']
    for rows in (16, 64):
        pad = (-v) % rows
        h = torch.cat([hit, hit.new_zeros(pad, k)]) if pad else hit
        pair = h.reshape(-1, rows, k).any(1)               # (groups, K)
        live = pair.any(1)
        n_pair = int(pair.sum())
        parts.append(
            f'{rows}-row: pairs without a hit {1 - pair.float().mean().item():.4f} '
            f'of all, {1 - pair[live].float().mean().item():.4f} of the live '
            f'groups ({int(live.sum())} of {len(live)} groups live), '
            f'rows that hit in a pair with a hit {int(hit.sum()) / max(1, n_pair * rows):.4f}')
    log('; '.join(parts))


def time_gather_gemm(name, layer, feats, rbk, n_launch):
    """Hold the gather-GEMM against its plain version at one layer's inputs
    (bf16, as the main path feeds it); time both and the matmul yardstick."""
    from crb_active_3ddet_torch.ops import cuda_kernels
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import subm_conv3d_gather
    cdt = torch.bfloat16
    b_, v, cin = feats.shape
    f = feats.to(cdt).reshape(b_ * v, cin).contiguous()
    w = layer[0].weight.to(cdt).contiguous()
    k, _, cout = w.shape
    got = cuda_kernels.sparse_conv_gather_gemm(f, rbk, w)
    ref = subm_conv3d_gather(f, rbk, w)
    err = (got - ref).abs().max().item()
    tol = 1e-4 * (1 + ref.abs().max().item())
    if not err <= tol:
        raise RuntimeError(f'{name}: max err {err} > {tol}')
    if not torch.equal(got, cuda_kernels.sparse_conv_gather_gemm(f, rbk, w)):
        raise RuntimeError(f'{name}: two runs on the same inputs differ')
    rulebook_emptiness(name, rbk)
    ms = graph_time_ms(lambda: cuda_kernels.sparse_conv_gather_gemm(f, rbk, w))
    call_ms = cuda_time_ms(lambda: cuda_kernels.sparse_conv_gather_gemm(f, rbk, w))
    plain_ms = cuda_time_ms(lambda: subm_conv3d_gather(f, rbk, w))
    g = f[torch.clamp(rbk, min=0).long()].reshape(rbk.shape[0], k * cin)
    w2 = w.reshape(k * cin, cout)
    lib_ms = graph_time_ms(lambda: torch.matmul(g, w2))
    nnz = int((rbk >= 0).sum())
    nbytes = f.numel() * 2 + rbk.numel() * 4 + w.numel() * 2 + ref.numel() * 4
    entry = _entry(name, 'crb_active_3ddet_torch/csrc/gather_gemm.cu',
                   'crb_active_3ddet_tpu/ops/pallas_kernels.py:60', n_launch, err, ms,
                   plain_ms, nbytes, 2 * nnz * cin * cout, PEAK[cdt], lib_ms)
    log(f'{name}: V_out {rbk.shape[0]} K {k} {cin}->{cout} '
        f'nnz {nnz}: err {err:.2e} (tol {tol:.1e}) kernel {ms:.4f} ms on the card '
        f'(graph replay; {call_ms:.4f} ms a call as the host enqueues it), '
        f'plain {plain_ms:.4f} ms, matmul yardstick {lib_ms:.4f} ms (graph replay), '
        f'bound {entry["bound_ms"]:.4f} ms')
    return entry


def fps_equal(points, valid, k, tag):
    """The FPS kernel against its plain version, for equality; returns the
    indices and the largest index difference (0, or it raised).  Every chosen
    index of a frame with valid points is valid."""
    from crb_active_3ddet_torch.ops import cuda_fps
    got = cuda_fps.farthest_point_sample_cuda(points, valid, k)
    torch.cuda.synchronize()
    ref = cuda_fps.fps_plain(points, valid, k)
    wrong = int((got != ref).sum())
    if wrong:
        raise RuntimeError(f'FPS {tag}: {wrong} of {got.numel()} indices differ '
                           f'from the plain version')
    chosen_valid = torch.gather(valid, 1, got.long())
    has_valid = valid.any(dim=1, keepdim=True)
    if not (chosen_valid | ~has_valid).all():
        raise RuntimeError(f'FPS {tag}: an invalid point was chosen')
    if not (got[~has_valid.expand_as(got)] == 0).all():
        raise RuntimeError(f'FPS {tag}: a frame without valid points must give 0')
    return got, float((got - ref).abs().max())


def time_fps(name, points, valid, k, n_launch):
    """Hold the FPS kernel to its plain version at the main path's inputs and
    at small shapes (random and snapped to a lattice, where the maxima tie);
    time kernel and plain version; return the kernel's JSON entry."""
    from crb_active_3ddet_torch.ops import cuda_fps
    got, err = fps_equal(points, valid, k, 'main path')
    distinct = min(len(torch.unique(r)) for r in got)
    for n, kk, nv in FPS_SMALL:
        if n == 'capacity':
            n = nv = cuda_fps.max_points()
            if n < 18432:
                raise RuntimeError(f'FPS capacity {n} shrank below 18432')
        for snapped in (False, True):
            rng = np.random.RandomState(n + kk)
            pts = (rng.randint(-8, 9, (3, n, 3)) / 8 if snapped
                   else rng.randn(3, n, 3) * 8).astype(np.float32)
            ok = np.broadcast_to(np.arange(n) < nv, (3, n)).copy()
            fps_equal(torch.from_numpy(pts).to(points.device),
                      torch.from_numpy(ok).to(points.device), kk,
                      f'({n}, {kk}, {nv}, snapped={snapped})')
    ms = cuda_time_ms(lambda: cuda_fps.farthest_point_sample_cuda(points, valid, k),
                      warmup=2, iters=10)
    plain_ms = cuda_time_ms(lambda: cuda_fps.fps_plain(points, valid, k),
                            warmup=0, iters=2)
    p1, v1 = points[:1].contiguous(), valid[:1].contiguous()
    one_ms = cuda_time_ms(lambda: cuda_fps.farthest_point_sample_cuda(p1, v1, k),
                          warmup=2, iters=10)
    b, n, _ = points.shape
    nbytes = points.numel() * 4 + valid.numel() + b * k * 4
    entry = _entry(name, 'crb_active_3ddet_torch/csrc/fps.cu',
                   'crb_active_3ddet_tpu/ops/pallas_kernels.py:148', n_launch, err, ms,
                   plain_ms, nbytes, b * (k - 1) * n * FPS_OPS_PER_POINT_STEP,
                   PEAK[torch.float32])
    log(f'{name} ({b}, {n}) -> {k}: equal to the plain version (also at '
        f'{len(FPS_SMALL)} other shapes, N = 1 up to the capacity '
        f'{cuda_fps.max_points()}, random and snapped); fewest distinct '
        f'keypoints in a frame {distinct}; kernel {ms:.4f} ms ({one_ms:.4f} ms for '
        f'one frame alone), plain {plain_ms:.4f} ms, bound {entry["bound_ms"]:.4f} ms '
        f'(a serial chain of {k - 1} cluster-wide argmax steps, '
        f'{ms / (k - 1) * 1e3:.3f} us each: latency, not this bound, sets its time)')
    return entry


def check_reduced(cfg_file, dev):
    """Reduced model in f32: the card's kernels against the CPU path."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.runtime.train import host_to_device_batch
    small = reduced_cfg(load_config(cfg_file))
    name = small.MODEL.NAME
    _, sloader, _, sstep_gpu = build(small, 2, dev, seed=1, cls_bias=0.0)
    _, _, _, sstep_cpu = build(small, 2, torch.device('cpu'), seed=1, cls_bias=0.0)
    sb = next(iter(sloader))
    pg, rg = sstep_gpu(host_to_device_batch(sb, dev))
    pc, rc = sstep_cpu(host_to_device_batch(sb, 'cpu'))
    for k in ('pred_valid', 'pred_labels'):
        if not torch.equal(pg[k].cpu(), pc[k]):
            raise RuntimeError(f'reduced {name} f32: {k} differs card vs CPU')
    for k in ('pred_boxes', 'pred_scores'):
        e = (pg[k].cpu() - pc[k]).abs().max().item()
        log(f'reduced {name} f32 card vs CPU {k}: max err {e:.2e} (tol 1e-4)')
        if not e <= 1e-4:
            raise RuntimeError(f'reduced {name} f32: {k} differs card vs CPU')
    if rg.keys() != rc.keys() or not all(torch.equal(rg[k].cpu(), rc[k]) for k in rc):
        raise RuntimeError(f'reduced {name} f32: recall record differs card vs CPU')
    if not pc['pred_valid'].any():
        raise RuntimeError(f'reduced {name} f32: no box kept')
    log(f"reduced {name} kept {pc['pred_valid'].sum(-1).tolist()}, recall record "
        + ', '.join(f'{k} {v.tolist()}' for k, v in rc.items()) + ' (card = CPU)')


def drive_path(cfg_file, dev, prefix, nms_tags, overlap_tags, n_iter):
    """One detector's eval step at full width: counters to 0, one step,
    counters read; output checks; step time, stages, profile; kernel path vs
    plain path; every kernel vs its plain version at this path's inputs.
    ``nms_tags`` and ``overlap_tags`` name the NMS mask and float overlap
    calls the step must make, in order.  Returns the kernels' JSON entries."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.ops import (cuda_fps, cuda_kernels, cuda_overlap,
                                            iou3d, nms, pointnet2)
    from crb_active_3ddet_torch.runtime.train import (host_to_device_batch,
                                                      prepare_device_batch)
    cfg = load_config(cfg_file)
    name = cfg.MODEL.NAME
    log(f'==== {name}: {cfg_file}, batch {BATCH} ====')
    dataset, loader, model, step = build(cfg, BATCH, dev, seed=0, cls_bias=CLS_BIAS)
    two_stage = hasattr(model, 'roi_head')
    host = next(iter(loader))
    batch = host_to_device_batch(host, dev)
    # each sparse conv layer's inputs and the gather-GEMM launches it made
    captured, launched, overlap_calls, fps_calls = [], [], [], []
    mask_calls, fixpoint_calls = [], []
    layers = [m for m in model.backbone_3d.modules()
              if type(m).__name__ == 'SparseConvLayer']
    hooks = [m.register_forward_pre_hook(lambda mod, args: captured.append(
        (mod, args[0], args[1], cuda_kernels.launches))) for m in layers]
    hooks += [m.register_forward_hook(lambda mod, args, out: launched.append(
        cuda_kernels.launches - captured[len(launched)][3])) for m in layers]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.launches = cuda_overlap.launches = cuda_overlap.mask_launches = 0
    cuda_fps.launches = 0
    with recording(iou3d, 'boxes_overlap_bev_cuda', overlap_calls,
                   lambda: cuda_overlap.launches), \
            recording(nms, 'nms_mask', mask_calls, lambda: cuda_overlap.mask_launches), \
            recording(nms, '_fixpoint_words', fixpoint_calls), \
            recording(pointnet2, 'farthest_point_sample_cuda', fps_calls,
                      lambda: cuda_fps.launches):
        preds, rec = step(batch)
    torch.cuda.synchronize()
    counts = {'gather_gemm': cuda_kernels.launches,
              'overlap_bev': cuda_overlap.launches,
              'nms_mask': cuda_overlap.mask_launches, 'fps': cuda_fps.launches}
    for h in hooks:
        h.remove()
    log(f'{name} main path launches: {counts}; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    expected = {'gather_gemm': len(SPARSE_LAYERS), 'overlap_bev': len(overlap_tags),
                'nms_mask': len(nms_tags), 'fps': 1 if two_stage else 0}
    for kernel, n in expected.items():
        if counts[kernel] < n:
            raise RuntimeError(f'{name}: kernel {kernel} was launched '
                               f'{counts[kernel]} times on the main path, '
                               f'expected at least {n}')
    if len(captured) != len(SPARSE_LAYERS):
        raise RuntimeError(f'expected {len(SPARSE_LAYERS)} sparse conv layers, '
                           f'saw {len(captured)}')
    if sum(launched) != counts['gather_gemm']:
        raise RuntimeError(f'gather-GEMM launches per layer {launched} '
                           f"do not add up to {counts['gather_gemm']}")
    for kind, calls, tags in (('overlap_bev', overlap_calls, overlap_tags),
                              ('nms_mask', mask_calls, nms_tags)):
        if [n for _, n, _ in calls] != [1] * len(tags) or len(tags) != counts[kind]:
            raise RuntimeError(f'{name}: expected the {kind} calls {tags}, one launch '
                               f'each, saw {[(tuple(a[0].shape), n) for a, n, _ in calls]}')
    if len(fixpoint_calls) != len(nms_tags):
        raise RuntimeError(f'{name}: {len(fixpoint_calls)} NMS fixpoints for {nms_tags}')
    if two_stage and [n for _, n, _ in fps_calls] != [1]:
        raise RuntimeError(f'{name}: expected one FPS call that launches once '
                           f'for the whole batch, saw {[n for _, n, _ in fps_calls]}')

    for k, v in preds.items():
        if v.dtype.is_floating_point and not torch.isfinite(v).all():
            raise RuntimeError(f'non-finite {k}')
    if preds['pred_boxes'].shape != (BATCH, 500, 7):
        raise RuntimeError(f"pred_boxes shape {tuple(preds['pred_boxes'].shape)}")
    if rec is None or not (rec['gt'] > 0).all():
        raise RuntimeError('no recall record, or a frame without ground truth')

    for _ in range(2):                                  # warm-up
        step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_iter):
        p, _ = step(batch)
    p['pred_scores'].cpu()
    step_s = (time.perf_counter() - t) / n_iter

    vox = prepare_device_batch(batch, dataset.voxel_cfg, dataset.grid_size,
                               dataset.point_cloud_range, dataset.voxel_size)
    out = check_kernel_path(model, vox)
    thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    alive = (torch.sigmoid(out['batch_cls_preds']).max(-1).values >= thresh).sum(-1)
    kept = preds['pred_valid'].sum(-1)
    # SECOND's NMS must suppress some of the many live anchors; PV-RCNN's
    # final NMS sees RoIs that already went through the proposal NMS
    if not ((kept > 0).all() and (kept <= alive).all()
            and (two_stage or (kept < alive).all())):
        raise RuntimeError(f'NMS check: kept {kept.tolist()} alive {alive.tolist()}')
    pcr = np.asarray(dataset.point_cloud_range, np.float64)
    vsz = np.asarray(dataset.voxel_size, np.float64)
    gsz = np.asarray(dataset.grid_size, np.int64)
    max_real = 0
    for f in range(BATCH):
        pts = host['points'][f, :host['num_points'][f], :3]
        c = np.floor((pts - pcr[:3]) / vsz).astype(np.int64)
        ok = (c >= 0).all(1) & (c < gsz[None]).all(1)
        max_real = max(max_real, len(np.unique((c[ok, 2] * gsz[1] + c[ok, 1])
                                               * gsz[0] + c[ok, 0])))
    cap = dataset.voxel_cfg['max_voxels']
    log(f'{name} eval step: {step_s * 1e3:.2f} ms/step mean of {n_iter}, '
        f'{BATCH / step_s:.2f} scans/s; boxes alive {alive.tolist()}, '
        f'kept {kept.tolist()}; max real voxels {max_real} of buffer {cap}; '
        f"recall record {', '.join(f'{k} {v.tolist()}' for k, v in rec.items())}")
    # second_synth.yaml's buffer holds every scene; pv_rcnn_synth.yaml's own
    # MAX_NUMBER_OF_VOXELS (16000) is below the densest scenes, so that
    # config truncates, here as in the JAX package
    if max_real > cap and not two_stage:
        raise RuntimeError('voxel buffer truncates real voxels')
    if two_stage:
        roi_valid = out['roi_valid'].sum(-1)
        log(f"{name} points per frame {host['num_points'].tolist()} of "
            f"{host['points'].shape[1]}; valid RoIs {roi_valid.tolist()} of "
            f"{out['roi_valid'].shape[1]}; RoI labels "
            f"{torch.bincount(out['roi_labels'].flatten(), minlength=4).tolist()}")
        if not (roi_valid == out['roi_valid'].shape[1]).all():
            raise RuntimeError('the proposal layer did not fill its RoIs')
    stages = stage_ms(model, dataset, batch, cfg.MODEL.POST_PROCESSING,
                      len(cfg.CLASS_NAMES))
    log(f'{name} eval step stages (ms, synchronised): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items())
        + f'; sum {sum(stages.values()):.2f}')
    profile_step(step, batch)

    # ---- each kernel against its plain version at this path's inputs ----
    results = [time_gather_gemm(f'{prefix}gather_gemm[{lname}]', layer, feats, rbk, n)
               for lname, (layer, feats, rbk, _), n
               in zip(SPARSE_LAYERS, captured, launched)]
    for tag, ((boxes, alive, thresh), n, words), (_, _, (_, rounds)) in zip(
            nms_tags, mask_calls, fixpoint_calls):
        if not torch.equal(cuda_overlap.nms_mask(boxes, alive, thresh), words):
            raise RuntimeError(f'nms_mask {tag}: a second call differs from the step\'s')
        results.append(time_mask(f'{prefix}nms_mask[{tag}]', boxes, alive, thresh, n,
                                 rounds, f'{name} {tag}'))
    for tag, ((a, b), n, _) in zip(overlap_tags, overlap_calls):
        results.append(time_overlap(f'{prefix}overlap_bev[{tag}]', a, b, n,
                                    f'{name} {tag}'))
    if two_stage:
        (points, valid, k), n, _ = fps_calls[0]
        results.append(time_fps(f'{prefix}fps', points, valid, k, n))
    return results


def train_stage_ms(model, optimizer, dataset, batch, iters=3):
    """Host-clock time of each stage of one train step, synchronised at the
    stage boundaries: voxelize, forward (training mode, with the target
    assignment), loss, backward, optimizer (clip + AdamW)."""
    from crb_active_3ddet_torch.runtime.train import prepare_device_batch
    totals = {}

    def timed(name, fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        totals[name] = totals.get(name, 0.0) + (time.perf_counter() - t) * 1e3 / iters
        return out

    model.train()
    for _ in range(iters):
        vox = timed('voxelize', prepare_device_batch, batch, dataset.voxel_cfg,
                    dataset.grid_size, dataset.point_cloud_range, dataset.voxel_size)
        out = timed('forward', model, vox)
        loss, _ = timed('loss', model.compute_loss, out)
        optimizer.zero_grad()
        timed('backward', loss.backward)
        timed('optimizer', optimizer.step)
    return totals


def grads_of(model, vox):
    """Forward in training mode, loss and backward from the model's present
    weights: (loss terms, {parameter: gradient})."""
    model.train()
    for p in model.parameters():
        p.grad = None
    loss, tb = model.compute_loss(model(vox))
    loss.backward()
    return ({k: tb[k].detach() for k in TRAIN_LOSSES},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def _apart(a, b):
    """Per parameter of two gradient dicts: (||a - b|| / ||b||, cosine)."""
    return {n: (((a[n] - b[n]).norm() / b[n].norm()).item(),
                torch.nn.functional.cosine_similarity(a[n].flatten(), b[n].flatten(),
                                                      dim=0, eps=1e-30).item())
            for n in b}


def check_train_kernel_path(model, vox, mode):
    """One train step's loss and gradients from the same weights and batch,
    on the kernel path and on the plain path, both on the card, each run
    twice (the caller turns torch's deterministic algorithms on; the
    hand-written kernels sum in a fixed order already); ``mode`` 'bf16' as
    configured, 'f32' with USE_BF16 off in both backbones."""
    cfgs = (model.backbone_3d.model_cfg, model.backbone_2d.model_cfg)
    saved = [c.get('USE_BF16', False) for c in cfgs]
    for c in cfgs:
        c['USE_BF16'] = mode == 'bf16'
    (tb, grads), (_, grads_again) = grads_of(model, vox), grads_of(model, vox)
    with plain_versions():
        (tb_ref, grads_ref), (_, grads_ref_again) = grads_of(model, vox), grads_of(model, vox)
    for c, v in zip(cfgs, saved):
        c['USE_BF16'] = v
    for path, again in (('kernel', _apart(grads_again, grads)),
                        ('plain', _apart(grads_ref_again, grads_ref))):
        spread = sorted(e for e, _ in again.values())
        log(f'train {path} path run twice, {mode}: gradients ||diff||/||ref|| largest '
            f'{spread[-1]:.3e}, median {spread[len(spread) // 2]:.3e}')
    tol = TRAIN_TOL[mode]
    loss_err = {k: (abs(tb[k] - tb_ref[k]) / tb_ref[k].abs()).item() for k in TRAIN_LOSSES}
    apart = _apart(grads, grads_ref)
    worst = sorted(apart.items(), key=lambda kv: -kv[1][0])
    median = sorted(e for e, _ in apart.values())[len(apart) // 2]
    least_cos = min(apart.items(), key=lambda kv: kv[1][1])
    log(f'train kernel path vs plain, {mode}: loss terms |diff|/|ref| '
        + ', '.join(f'{k} {v:.3e}' for k, v in loss_err.items())
        + f" (tol {tol['loss']:.0e}); gradients ||diff||/||ref||, largest: "
        + ', '.join(f'{n} {e:.3e}' for n, (e, _) in worst[:4])
        + f" (tol {tol.get('grad', 'none')}); median {median:.3e} (tol "
        f"{tol['median']:.2g}); least cosine {least_cos[1][1]:.6f} ({least_cos[0]}; "
        f"tol {tol.get('cos', 'none')})")
    log(f'train kernel path vs plain, {mode}, per sparse layer weight gradient: '
        + ', '.join(f'{n.split(".", 1)[1][:-9]} {e:.2e}' for n, (e, _) in apart.items()
                    if n.startswith('backbone_3d') and n.endswith('.0.weight')))
    if not max(loss_err.values()) <= tol['loss']:
        raise RuntimeError(f'train step {mode}: loss terms differ kernel vs plain: '
                           f'{loss_err}')
    if not (worst[0][1][0] <= tol.get('grad', float('inf')) and median <= tol['median']
            and least_cos[1][1] >= tol.get('cos', -1.0)):
        raise RuntimeError(f'train step {mode}: gradient of {worst[0][0]} differs '
                           f'kernel vs plain by {worst[0][1][0]:.3e}, median {median:.3e}, '
                           f'least cosine {least_cos[1][1]:.6f} ({least_cos[0]})')


def time_dgrad(name, args, n_launch):
    """Hold the dgrad (K2 over the inverse rulebook) against its plain
    version at one layer's backward inputs (error over the sum of the
    products' magnitudes, as the wgrad's), check equal bits on a second
    run; time both and the matmul yardstick over the materialised inverse
    gather."""
    from crb_active_3ddet_torch.ops import cuda_kernels
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_gemm_dgrad_plain
    dout, rbk, inv, w, v_in = args
    got = cuda_kernels.gather_gemm_dgrad(*args)
    ref = gather_gemm_dgrad_plain(dout, rbk, w, v_in)
    scale = gather_gemm_dgrad_plain(dout.abs(), rbk, w.abs(), v_in)
    err = ((got - ref).abs() / (scale + 1e-30)).max().item()
    if not err <= 1e-5:
        raise RuntimeError(f'{name}: max err {err} of the products\' magnitude > 1e-5')
    ref_max, ref_median = ref.abs().max().item(), ref.abs().median().item()
    if not torch.equal(got, cuda_kernels.gather_gemm_dgrad(*args)):
        raise RuntimeError(f'{name}: two runs on the same inputs differ')
    k, cin, cout = w.shape
    ms = graph_time_ms(lambda: cuda_kernels.gather_gemm_dgrad(*args))
    plain_ms = cuda_time_ms(lambda: gather_gemm_dgrad_plain(dout, rbk, w, v_in),
                            warmup=1, iters=3)
    dc = dout.to(w.dtype)
    gi = (dc[torch.clamp(inv, min=0).long()] * (inv >= 0)[..., None]).reshape(v_in, k * cout)
    wt = w.transpose(1, 2).reshape(k * cout, cin).contiguous()
    lib_ms = graph_time_ms(lambda: torch.matmul(gi, wt))
    nnz = int((inv >= 0).sum())
    nbytes = dout.numel() * 4 + inv.numel() * 4 + w.numel() * w.element_size() + v_in * cin * 4
    entry = _entry(name, 'crb_active_3ddet_torch/csrc/gather_gemm.cu',
                   'crb_active_3ddet_tpu/ops/pallas_kernels.py:60', n_launch, err, ms,
                   plain_ms, nbytes, 2 * nnz * cin * cout, PEAK[w.dtype], lib_ms)
    log(f'{name}: V_in {v_in} K {k} {cout}->{cin} nnz {nnz}: |ref| max {ref_max:.3e}, '
        f'median {ref_median:.3e}; err {err:.2e} of the products\' magnitude (tol 1e-5), '
        f'equal bits on a second run; call {ms:.4f} ms on the card (graph '
        f'replay: cast of dout, W transposed, pack, kernel), plain {plain_ms:.4f} ms, '
        f'matmul yardstick {lib_ms:.4f} ms, bound {entry["bound_ms"]:.4f} ms '
        f'({entry["bound_by"]})')
    return entry


def time_wgrad(name, args, n_launch):
    """Hold the wgrad kernel against its plain version at one layer's
    backward inputs (error over the sum of the products' magnitudes, which
    bounds an f32 sum's rounding), check equal bits on a second run, on the
    route the step ran (bf16: tensor cores) and on the f32 route with the
    same numbers; time the step's route, the plain version, the
    matmul yardstick over the materialised gather and the transpose of the
    rulebook that the tensor-core route reads.  ``bound_ms`` counts the
    route's own arithmetic (three bf16 products at the bf16 peak on tensor
    cores), ``bound_f32_ms`` the f32 products at the f32 peak."""
    from crb_active_3ddet_torch.ops import cuda_kernels
    from crb_active_3ddet_torch.ops.sparse.rulebook import transpose_rulebook
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_gemm_wgrad_plain
    feats, rbk, dout = args[:3]
    route = cuda_kernels.wgrad_route(feats.dtype)
    errs = {}
    for r, xa in ((route, args), ('f32', (feats.float(), rbk, dout))):
        got = cuda_kernels.gather_gemm_wgrad(*xa)
        ref = gather_gemm_wgrad_plain(xa[0], rbk, dout)
        scale = gather_gemm_wgrad_plain(xa[0].abs(), rbk, dout.abs())
        err = ((got - ref).abs() / (scale + 1e-30)).max().item()
        if not err <= 1e-5:
            raise RuntimeError(f'{name} ({r}): max err {err} of the products\' magnitude > 1e-5')
        if not torch.equal(got, cuda_kernels.gather_gemm_wgrad(*xa)):
            raise RuntimeError(f'{name} ({r}): two runs on the same inputs differ')
        errs[r] = err
    k = rbk.shape[1]
    v_in, cin = feats.shape
    cout = dout.shape[1]
    ms = graph_time_ms(lambda: cuda_kernels.gather_gemm_wgrad(*args))
    plain_ms = cuda_time_ms(lambda: gather_gemm_wgrad_plain(feats, rbk, dout),
                            warmup=1, iters=3)
    g = (feats.float()[torch.clamp(rbk, min=0).long()]
         * (rbk >= 0)[..., None]).reshape(rbk.shape[0], k * cin)
    lib_ms = graph_time_ms(lambda: torch.matmul(g.t(), dout))
    t_ms = graph_time_ms(lambda: transpose_rulebook(rbk))
    nnz = int((rbk >= 0).sum())
    nbytes = (feats.numel() * feats.element_size() + rbk.numel() * 4 + dout.numel() * 4
              + k * cin * cout * 4)
    products = 2 * nnz * cin * cout
    if route == 'mma':
        ops, peak = 3 * products, PEAK[torch.bfloat16]
    else:
        ops, peak = products, PEAK[torch.float32]
    entry = _entry(name, 'crb_active_3ddet_torch/csrc/gather_gemm_wgrad.cu',
                   'crb_active_3ddet_tpu/ops/pallas_kernels.py:60', n_launch, errs[route],
                   ms, plain_ms, nbytes, ops, peak, lib_ms)
    entry['path'] = route
    entry['bound_f32_ms'] = max(nbytes / MEM_BW, products / PEAK[torch.float32]) * 1e3
    log(f'{name}: route {route}, V_out {rbk.shape[0]} K {k} {cin}x{cout} nnz {nnz}: err '
        + ', '.join(f'{r} {e:.2e}' for r, e in errs.items())
        + ' of the products\' magnitude (tol 1e-5), equal bits on a second run; call '
        f'{ms:.4f} ms on the card (graph replay: partial sums + slice sum), plain '
        f'{plain_ms:.4f} ms, matmul yardstick {lib_ms:.4f} ms, bound '
        f'{entry["bound_ms"]:.4f} ms ({entry["bound_by"]}, the route\'s arithmetic), f32 bound '
        f'{entry["bound_f32_ms"]:.4f} ms; rulebook transpose {t_ms:.4f} ms')
    return entry


def build_train(cfg, batch_size, device, seed):
    """Train split loader (seeded shuffle and augmentation), seeded model,
    AdamW on the config's one-cycle schedule, the train step."""
    from crb_active_3ddet_torch.datasets import build_dataloader
    from crb_active_3ddet_torch.models.detectors import build_detector, init_weights
    from crb_active_3ddet_torch.runtime.optimization import build_optimizer
    from crb_active_3ddet_torch.runtime.train import init_train_state, make_train_step
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                          workers=0, training=True)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device='cpu')
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    total = int(cfg.OPTIMIZATION.NUM_EPOCHS) * len(loader)
    optimizer, schedule = build_optimizer(cfg.OPTIMIZATION, total, model.parameters())
    state = init_train_state(model, optimizer)
    return dataset, loader, state, make_train_step(model, optimizer, dataset), schedule


def first_batch(loader):
    torch.manual_seed(0)
    np.random.seed(0)
    return next(iter(loader))


def drive_train(dev, n_iter=5):
    """SECOND's train step at full width, batch 8: counters to 0, one step,
    counters read (12 K2 forward, 11 dgrad, 12 wgrad launches); outputs
    checked; step time, stages, profile; kernel path vs plain path; dgrad
    and wgrad against their plain versions at every layer's inputs."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.ops import cuda_kernels
    from crb_active_3ddet_torch.runtime.train import (host_to_device_batch,
                                                      prepare_device_batch)
    cfg = load_config(SECOND_CFG)
    log(f'==== {cfg.MODEL.NAME} train step: {SECOND_CFG}, train split, batch {BATCH} ====')
    dataset, loader, state, step, schedule = build_train(cfg, BATCH, dev, seed=0)
    model = state.model
    host = first_batch(loader)
    batch = host_to_device_batch(host, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dcalls, wcalls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.launches = cuda_kernels.dgrad_launches = cuda_kernels.wgrad_launches = 0
    with recording(cuda_kernels, 'gather_gemm_dgrad', dcalls,
                   lambda: cuda_kernels.dgrad_launches), \
            recording(cuda_kernels, 'gather_gemm_wgrad', wcalls,
                      lambda: cuda_kernels.wgrad_launches):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = {'gather_gemm': cuda_kernels.launches,
              'gather_gemm_dgrad': cuda_kernels.dgrad_launches,
              'gather_gemm_wgrad': cuda_kernels.wgrad_launches}
    log(f'train step launches: {counts}; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    expected = {'gather_gemm': len(SPARSE_LAYERS),
                'gather_gemm_dgrad': len(SPARSE_LAYERS) - 1,
                'gather_gemm_wgrad': len(SPARSE_LAYERS)}
    if counts != expected:
        raise RuntimeError(f'train step launches {counts}, expected {expected}')
    if [n for _, n, _ in dcalls] != [1] * len(dcalls) or \
            [n for _, n, _ in wcalls] != [1] * len(wcalls):
        raise RuntimeError('a dgrad or wgrad call did not launch its kernel exactly once')
    values = {k: v.item() for k, v in metrics.items()}
    if not all(np.isfinite(v) and v > 0 for v in values.values()):
        raise RuntimeError(f'train step losses {values}')
    for n, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise RuntimeError(f'train step: no or non-finite gradient for {n}')
        if torch.equal(p, before[n]):
            raise RuntimeError(f'train step: {n} did not move')
    moved = [k for k in before if k.endswith('running_var')
             and not torch.equal(model.state_dict()[k], before[k])]
    if len(moved) != sum(1 for k in before if k.endswith('running_var')):
        raise RuntimeError('train step: not every BatchNorm updated its running variance')
    log('train step 1: ' + ', '.join(f'{k} {v:.4f}' for k, v in values.items())
        + f'; lr {schedule(0):.3e}; every parameter moved, {len(moved)} BN running '
        'statistics updated')

    for _ in range(2):                                  # warm-up
        step(state, batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_iter):
        _, m = step(state, batch)
    m['loss'].item()
    step_s = (time.perf_counter() - t) / n_iter
    log(f'SECONDNet train step: {step_s * 1e3:.2f} ms/step mean of {n_iter}, '
        f'{BATCH / step_s:.2f} samples/s; loss after {state.step} steps '
        f"{m['loss'].item():.4f}")
    stages = train_stage_ms(model, state.optimizer, dataset, batch)
    log('SECONDNet train step stages (ms, synchronised): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()) + f'; sum {sum(stages.values()):.2f}')
    profile_step(lambda b: step(state, b), batch)

    # kernel path vs plain path from the seeded weights and with every op
    # deterministic, so that the readings repeat between runs (the steps
    # above leave weights that do not)
    model.load_state_dict(before)
    torch.use_deterministic_algorithms(True, warn_only=True)
    vox = prepare_device_batch(batch, dataset.voxel_cfg, dataset.grid_size,
                               dataset.point_cloud_range, dataset.voxel_size)
    check_train_kernel_path(model, vox, 'bf16')
    check_train_kernel_path(model, vox, 'f32')
    torch.use_deterministic_algorithms(False)
    # dgrad runs from the last layer back (conv_out first, conv1.0 last);
    # wgrad likewise, conv_input last
    dnames, wnames = SPARSE_LAYERS[1:][::-1], SPARSE_LAYERS[::-1]
    results = [time_dgrad(f'train.gather_gemm_dgrad[{lname}]', args, n)
               for lname, (args, n, _) in zip(dnames, dcalls)]
    results += [time_wgrad(f'train.gather_gemm_wgrad[{lname}]', args, n)
                for lname, (args, n, _) in zip(wnames, wcalls)]
    for lname, (args, _, _) in zip(wnames, wcalls):
        if args[0].shape[1] != dict(zip(SPARSE_LAYERS, (4, 16, 16, 32, 32, 32, 64, 64, 64,
                                                         64, 64, 64)))[lname]:
            raise RuntimeError(f'wgrad call order: {lname} has Cin {args[0].shape[1]}')
    return results


def check_reduced_train(dev):
    """Reduced SECOND in f32, one train step from the same weights and
    batch on the card and on the CPU: loss terms (rtol 1e-5), gradients
    (||diff|| <= 1e-4 ||ref|| + 1e-7), updated parameters (1e-6 where the
    clipped |g| >= 1e-5, else 2 lr) and BN running statistics (1e-5)."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.runtime.train import host_to_device_batch
    small = reduced_cfg(load_config(SECOND_CFG))
    out = []
    for d in (dev, torch.device('cpu')):
        _, loader, state, step, schedule = build_train(small, 2, d, seed=1)
        state, m = step(state, host_to_device_batch(first_batch(loader), d))
        out.append(({k: m[k].item() for k in TRAIN_LOSSES},
                    {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                    {k: v.cpu() for k, v in state.model.state_dict().items()}))
    (lg, gg, sg), (lc, gc, sc) = out
    for k in TRAIN_LOSSES:
        if not abs(lg[k] - lc[k]) <= 1e-5 * abs(lc[k]):
            raise RuntimeError(f'reduced SECOND train f32: {k} {lg[k]} card vs {lc[k]} CPU')
    gerr = max(((gg[n] - gc[n]).norm() / (gc[n].norm() + 1e-30)).item() for n in gc)
    for n in gc:
        if not (gg[n] - gc[n]).norm() <= 1e-4 * gc[n].norm() + 1e-7:
            raise RuntimeError(f'reduced SECOND train f32: gradient of {n} card vs CPU')
    lr, loose, bn = schedule(0), 0, 0.0      # the step clipped the gradients in place
    for k, v in sc.items():
        d = (sg[k] - v).abs()
        if k.endswith(('running_mean', 'running_var')):
            bn = max(bn, d.max().item())
            if not d.max() <= 1e-5:
                raise RuntimeError(f'reduced SECOND train f32: {k} card vs CPU')
        elif k in gc:
            firm = gc[k].abs() >= 1e-5
            if not (d[firm] <= 1e-6).all() or not (d <= 2 * lr + 1e-7).all():
                raise RuntimeError(f'reduced SECOND train f32: updated {k} card vs CPU')
            loose += int((~firm & (d > 1e-6)).sum())
    log(f'reduced SECONDNet train f32 card vs CPU: losses '
        + ', '.join(f'{k} {lg[k]:.6f} / {lc[k]:.6f}' for k in TRAIN_LOSSES)
        + f'; largest gradient ||diff||/||ref|| {gerr:.2e} (tol 1e-4); BN statistics '
        f'max diff {bn:.2e} (tol 1e-5); {loose} updated entries with clipped |g| < 1e-5 '
        f'differ by more than 1e-6 (within 2 lr)')


def ablate_gather_gemm(dev):
    """Time the gather-GEMM (bf16, graph replay) at the inputs of each sparse
    conv layer of the SECOND step, as built and with parts compiled out."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.ops import cuda_build, cuda_kernels
    from crb_active_3ddet_torch.runtime.train import host_to_device_batch
    _, loader, model, step = build(load_config(SECOND_CFG), BATCH, dev, seed=0,
                                   cls_bias=CLS_BIAS)
    captured = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: captured.append((mod, args[0], args[1])))
        for m in model.backbone_3d.modules() if type(m).__name__ == 'SparseConvLayer']
    step(host_to_device_batch(next(iter(loader)), dev))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    libs = cuda_build.build_variants('gather_gemm', {
        'as built': [], 'no gather': ['-DGG_ABLATE_A'], 'no weight reads': ['-DGG_ABLATE_B'],
        'neither': ['-DGG_ABLATE_A', '-DGG_ABLATE_B']}, cuda_kernels._SIG)
    for lname, (layer, feats, rbk) in zip(SPARSE_LAYERS, captured):
        f = feats.to(torch.bfloat16).reshape(-1, feats.shape[-1]).contiguous()
        w = layer[0].weight.to(torch.bfloat16).contiguous()
        k, cin, cout = w.shape
        out = torch.empty((rbk.shape[0], cout), dtype=torch.float32, device=dev)
        wpack = torch.empty(((k + 3) // 4 * 4, cin, cout), dtype=torch.bfloat16, device=dev)

        def launch(lib):
            cuda_build.check(lib, 'gather_gemm', lib.gather_gemm_launch(
                f.data_ptr(), rbk.data_ptr(), w.data_ptr(), wpack.data_ptr(),
                out.data_ptr(), rbk.shape[0], k, cin, cout, 1,
                torch.cuda.current_stream().cuda_stream))
        log(f'gather_gemm[{lname}] {cin}->{cout}, ms on the card (graph replay): '
            + ', '.join(f'{tag} {graph_time_ms(lambda: launch(lib)):.4f}'
                        for tag, lib in libs.items()))


def ablate_wgrad(dev):
    """Time the bf16 wgrad (graph replay of the launch, slice sum included)
    at the inputs of each sparse conv layer of the SECOND train step, as
    built and with its row gather, its mmas or both compiled out."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.ops import cuda_build, cuda_kernels
    from crb_active_3ddet_torch.runtime.train import host_to_device_batch
    _, loader, state, step, _ = build_train(load_config(SECOND_CFG), BATCH, dev, seed=0)
    wcalls = []
    with recording(cuda_kernels, 'gather_gemm_wgrad', wcalls):
        step(state, host_to_device_batch(first_batch(loader), dev))
    torch.cuda.synchronize()
    libs = cuda_build.build_variants('gather_gemm_wgrad', {
        'as built': [], 'no gather': ['-DGW_ABLATE_GATHER'], 'no mma': ['-DGW_ABLATE_MMA'],
        'neither': ['-DGW_ABLATE_GATHER', '-DGW_ABLATE_MMA']}, cuda_kernels._WSIG)
    for lname, (args, _, _) in zip(SPARSE_LAYERS[::-1], wcalls):
        feats, rbk, dout, rbt = args
        (v_out, k), cin, cout = rbk.shape, feats.shape[1], dout.shape[1]
        cut = (ctypes.c_int * 2)()
        libs['as built'].gather_gemm_wgrad_slices(v_out, k, cin, cout, 1, cut)
        partial = torch.empty((cut[0], k, cin, cout), dtype=torch.float32, device=dev)
        dw = torch.empty((k, cin, cout), dtype=torch.float32, device=dev)

        def launch(lib):
            cuda_build.check(lib, 'gather_gemm_wgrad', lib.gather_gemm_wgrad_launch(
                feats.data_ptr(), rbk.data_ptr(), rbt.data_ptr(), dout.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), v_out, k, cin, cout, 1,
                torch.cuda.current_stream().cuda_stream))
        log(f'gather_gemm_wgrad[{lname}] {cin}x{cout} nnz {int((rbk >= 0).sum())} slices '
            f'{cut[0]}, ms on the card (graph replay): '
            + ', '.join(f'{tag} {graph_time_ms(lambda: launch(lib)):.4f}'
                        for tag, lib in libs.items()))


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from crb_active_3ddet_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f'card: {smi}')
    if sys.argv[1:] == ['--ablate-k2']:
        ablate_gather_gemm(dev)
        return 0
    if sys.argv[1:] == ['--ablate-wgrad']:
        ablate_wgrad(dev)
        return 0

    t0 = time.perf_counter()
    built = cuda_build.build_all(['gather_gemm', 'gather_gemm_wgrad', 'overlap_bev',
                                  'fps'])
    log(f'kernel build: {time.perf_counter() - t0:.1f} s wall, per source '
        + ', '.join(f'{k} {v:.1f} s' for k, v in built.items()))
    for name, (_, report) in cuda_build.BUILD_LOG.items():
        log(f'  {name}: ptxas registers / static shared bytes / spill bytes: '
            + '; '.join(f'{entry} {regs}/{smem}/{spill}'
                        for entry, regs, smem, spill in ptxas_entries(report)))

    results = drive_path(SECOND_CFG, dev, '', ['nms'], ['recall'], n_iter=5)
    results += drive_path(PVRCNN_CFG, dev, 'pvrcnn.', ['proposal_nms', 'nms'],
                          ['recall'], n_iter=5)
    results += drive_train(dev)
    mask_stress(dev)
    check_reduced(SECOND_CFG, dev)
    check_reduced(PVRCNN_CFG, dev)
    check_reduced_train(dev)

    log(json.dumps({'kernels': results}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
