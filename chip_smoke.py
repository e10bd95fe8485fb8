"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It
  1. prints the card's name and power limit and builds the hand-written CUDA
     kernels (one nvcc per source, started together);
  2. drives the port's SECOND eval step (``make_eval_step``) at the full
     width of tools/cfgs/synthetic_models/second_synth.yaml, batch 8, from
     seeded random weights, with every kernel launch counter set to 0 just
     before and read just after, and records each kernel call's inputs;
  3. times the step, each of its stages, and one step under torch.profiler
     (kernel launches, host syncs, device time, busy share);
  4. checks the outputs: the same batch on the plain PyTorch versions (on the
     card) against the kernel path, at the 3D backbone's output, the BEV
     features, the head's raw outputs and the decoded pre-NMS predictions;
  5. holds each kernel against its plain version on the card at the inputs
     the main path gave it (the gather-GEMM at all 12 sparse-conv layers,
     bf16; the overlap at the NMS's (8, 1024, 1024), with degenerate rows,
     and at the recall record's (8, MAX_OBJECTS, 500)), and times kernel,
     plain version and library yardstick with CUDA events;
  6. runs a reduced SECOND in f32 on the card against the CPU path (which the
     CPU tests hold against the JAX reference), predictions and recall record.
Any failed check raises.  The last line is the device JSON; the line before
it holds the per-kernel measurements.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BW = 3.35e12                     # H100 SXM HBM3 bytes/s
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense FLOP/s
OVERLAP_OPS_PER_PAIR = 440           # f32 ops of the 8-slot clip, per pair
BATCH = 8
CFG = 'tools/cfgs/synthetic_models/second_synth.yaml'
# conv_cls bias of the seeded model: about 40 % of the anchors then score
# above SCORE_THRESH 0.1, so the NMS runs at its full MATRIX_CAP width
CLS_BIAS = -2.26
# kernel path vs plain path, bf16 main path: max |diff| / (1 + |ref|).  The
# two paths feed K2 the same operands and differ only in its f32 summation
# order; a changed sum rounds to another bf16 value at the next layer's
# input cast, which the later layers carry on.  Limits are 3-5x the
# readings on an H100 80GB HBM3 at 700 W (PERF.md, Findings): 3.4e-4,
# 1.8e-3, 2.0e-4, 6.4e-4, 6.4e-4, 1.5e-3 in this order.
E2E_TOL = {'encoded_spconv_features': 1e-3, 'spatial_features_2d': 5e-3,
           'cls_preds': 1e-3, 'box_preds': 2e-3, 'dir_cls_preds': 2e-3,
           'batch_box_preds': 5e-3}
SPARSE_LAYERS = ['conv_input', 'conv1.0', 'conv2.0', 'conv2.1', 'conv2.2',
                 'conv3.0', 'conv3.1', 'conv3.2', 'conv4.0', 'conv4.1',
                 'conv4.2', 'conv_out']


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


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions (on the
    card) — the comparison baseline; the port itself has no such switch."""
    from crb_active_3ddet_torch.models.backbones_3d import spconv_backbone
    from crb_active_3ddet_torch.ops import cuda_overlap, iou3d
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import subm_conv3d_gather
    saved = spconv_backbone.sparse_conv_gather_gemm, iou3d.boxes_overlap_bev_cuda
    spconv_backbone.sparse_conv_gather_gemm = subm_conv3d_gather
    iou3d.boxes_overlap_bev_cuda = cuda_overlap.overlap_bev_plain
    try:
        yield
    finally:
        spconv_backbone.sparse_conv_gather_gemm, iou3d.boxes_overlap_bev_cuda = saved


@contextlib.contextmanager
def recording_overlap(calls):
    """Append (boxes_a, boxes_b, launches) of every overlap call to calls."""
    from crb_active_3ddet_torch.ops import cuda_overlap, iou3d
    real = iou3d.boxes_overlap_bev_cuda

    def record(a, b):
        before = cuda_overlap.launches
        out = real(a, b)
        calls.append((a, b, cuda_overlap.launches - before))
        return out
    iou3d.boxes_overlap_bev_cuda = record
    try:
        yield
    finally:
        iou3d.boxes_overlap_bev_cuda = real


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
            d = timed('vfe', model.vfe, dict(d))
            d = timed('backbone_3d (rulebooks + 12 gather-GEMMs)', model.backbone_3d, d)
            d = timed('map_to_bev + backbone_2d', lambda x: model.backbone_2d(
                model.map_to_bev(x)), d)
            d = timed('dense_head', model.dense_head, d)
            preds = timed('post_processing (NMS, density)', pp.post_processing, d,
                          post_cfg, num_class)
            gt = d['gt_boxes']
            timed('recall record', pp.generate_recall_record, preds['pred_boxes'],
                  preds['pred_valid'], gt[..., :7], torch.abs(gt).sum(-1) > 0)
    return totals


def profile_step(step, batch, rows=10):
    """Trace one warm eval step with torch.profiler and print its summary."""
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
    log(events.table(sort_by='self_device_time_total', row_limit=rows,
                     max_name_column_width=60))


def reduced_cfg(cfg):
    """Reduced SECOND (grid 128×128×40, narrow BEV) for the CPU/card check."""
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


def check_kernel_path(model, vox):
    """The same batch through the plain versions on the card, held against
    the kernel path before the NMS.  Continuous tensors are compared as they
    are; the decoded boxes' heading modulo π, since a direction-bin argmax
    between two near-equal logits moves it by exactly π — each such flip
    must be a near-tie within the dir logits' own difference."""
    with torch.no_grad():
        out = model(vox)
        with plain_versions():
            ref = model(vox)
    errs, diffs = {}, {}
    for key in E2E_TOL:
        a, b = out[key].float(), ref[key].float()
        d = (a - b).abs()
        if key == 'batch_box_preds':
            dh = (a[..., 6] - b[..., 6]).remainder(np.pi)
            d[..., 6] = torch.minimum(dh, np.pi - dh)
        diffs[key] = d.max().item()
        errs[key] = (d / (1 + b.abs())).max().item()
        log(f'kernel path vs plain, {key} {tuple(b.shape)}: max |diff|/(1+|ref|) '
            f'= {errs[key]:.3e} (tol {E2E_TOL[key]:.0e}), max |diff| {diffs[key]:.3e}')
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
    bad = [k for k in E2E_TOL if not errs[k] <= E2E_TOL[k]]
    if bad:
        raise RuntimeError(f'kernel path disagrees with the plain path at {bad}')
    if not worst_gap <= 2 * diffs['dir_cls_preds']:
        raise RuntimeError('a direction-bin flip is not a near-tie')
    return out


def time_overlap(name, a, b, n_launch, tag):
    """Hold the overlap kernel against its plain version on (a, b); time
    both; return the kernel's JSON entry."""
    from crb_active_3ddet_torch.ops import cuda_overlap
    got = cuda_overlap.boxes_overlap_bev_cuda(a, b)
    ref = cuda_overlap.overlap_bev_plain(a, b)
    err = (got - ref).abs().max().item()
    if not err <= 1e-4:
        raise RuntimeError(f'overlap {tag}: max err {err} > 1e-4')
    ms = cuda_time_ms(lambda: cuda_overlap.boxes_overlap_bev_cuda(a, b))
    plain_ms = cuda_time_ms(lambda: cuda_overlap.overlap_bev_plain(a, b),
                            warmup=1, iters=3)
    bsz, n, m = got.shape
    nbytes = (a[..., :7].numel() + b[..., :7].numel() + bsz * n * m) * 4
    ops = bsz * n * m * OVERLAP_OPS_PER_PAIR
    bound = max(nbytes / MEM_BW, ops / PEAK[torch.float32]) * 1e3
    log(f'overlap_bev {tag} ({bsz}, {n}, {m}): err {err:.2e} (tol 1e-4), max |ref| '
        f'{ref.abs().max().item():.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'bound {bound:.4f} ms')
    return {'name': name, 'route': 'cuda',
            'source': 'crb_active_3ddet_torch/csrc/overlap_bev.cu',
            'replaces': 'crb_active_3ddet_tpu/ops/pallas_overlap.py:122',
            'launches': n_launch, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': 'bytes' if nbytes / MEM_BW >= ops / PEAK[torch.float32]
            else 'operations',
            'library_ms': None}


def time_gather_gemm(lname, layer, feats, rbk, n_launch):
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
        raise RuntimeError(f'gather-GEMM {lname}: max err {err} > {tol}')
    ms = cuda_time_ms(lambda: cuda_kernels.sparse_conv_gather_gemm(f, rbk, w))
    plain_ms = cuda_time_ms(lambda: subm_conv3d_gather(f, rbk, w))
    g = f[torch.clamp(rbk, min=0).long()].reshape(rbk.shape[0], k * cin)
    w2 = w.reshape(k * cin, cout)
    lib_ms = cuda_time_ms(lambda: torch.matmul(g, w2))
    nnz = int((rbk >= 0).sum())
    nbytes = f.numel() * 2 + rbk.numel() * 4 + w.numel() * 2 + ref.numel() * 4
    flops = 2 * nnz * cin * cout
    bound = max(nbytes / MEM_BW, flops / PEAK[cdt]) * 1e3
    log(f'gather_gemm {lname}: V_out {rbk.shape[0]} K {k} {cin}->{cout} '
        f'nnz {nnz}: err {err:.2e} (tol {tol:.1e}) kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, matmul yardstick {lib_ms:.4f} ms, '
        f'bound {bound:.4f} ms')
    return {'name': f'gather_gemm[{lname}]', 'route': 'cuda',
            'source': 'crb_active_3ddet_torch/csrc/gather_gemm.cu',
            'replaces': 'crb_active_3ddet_tpu/ops/pallas_kernels.py:60',
            'launches': n_launch, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': 'bytes' if nbytes / MEM_BW >= flops / PEAK[cdt] else 'operations',
            'library_ms': lib_ms}


def check_reduced(dev):
    """Reduced SECOND in f32: the card's kernels against the CPU path."""
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.runtime.train import host_to_device_batch
    small = reduced_cfg(load_config(CFG))
    _, sloader, _, sstep_gpu = build(small, 2, dev, seed=1, cls_bias=0.0)
    _, _, _, sstep_cpu = build(small, 2, torch.device('cpu'), seed=1, cls_bias=0.0)
    sb = next(iter(sloader))
    pg, rg = sstep_gpu(host_to_device_batch(sb, dev))
    pc, rc = sstep_cpu(host_to_device_batch(sb, 'cpu'))
    for k in ('pred_valid', 'pred_labels'):
        if not torch.equal(pg[k].cpu(), pc[k]):
            raise RuntimeError(f'reduced SECOND f32: {k} differs card vs CPU')
    for k in ('pred_boxes', 'pred_scores'):
        e = (pg[k].cpu() - pc[k]).abs().max().item()
        log(f'reduced SECOND f32 card vs CPU {k}: max err {e:.2e} (tol 1e-4)')
        if not e <= 1e-4:
            raise RuntimeError(f'reduced SECOND f32: {k} differs card vs CPU')
    if rg.keys() != rc.keys() or not all(torch.equal(rg[k].cpu(), rc[k]) for k in rc):
        raise RuntimeError('reduced SECOND f32: recall record differs card vs CPU')
    log(f"reduced SECOND kept {pc['pred_valid'].sum(-1).tolist()}, recall record "
        + ', '.join(f'{k} {v.tolist()}' for k, v in rc.items()) + ' (card = CPU)')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from crb_active_3ddet_torch.config import load_config
    from crb_active_3ddet_torch.ops import cuda_build, cuda_kernels, cuda_overlap
    from crb_active_3ddet_torch.runtime.train import (host_to_device_batch,
                                                      prepare_device_batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f'card: {smi}')

    t0 = time.perf_counter()
    built = cuda_build.build_all(['gather_gemm', 'overlap_bev'])
    log(f'kernel build: {time.perf_counter() - t0:.1f} s wall, per source '
        + ', '.join(f'{k} {v:.1f} s' for k, v in built.items()))
    for name, (_, report) in cuda_build.BUILD_LOG.items():
        regs = sorted({ln.split('Used ')[1].strip() for ln in report.splitlines()
                       if 'Used ' in ln})
        spill = [ln.strip() for ln in report.splitlines()
                 if 'spill' in ln and not ' 0 bytes spill stores, 0 bytes spill loads' in ln]
        log(f'  {name}: ptxas {"; ".join(regs)[:300]}; spills: {spill[:2] or "none"}')

    # ---- the main path: full-width SECOND eval step, batch 8 ----
    cfg = load_config(CFG)
    dataset, loader, model, step = build(cfg, BATCH, dev, seed=0, cls_bias=CLS_BIAS)
    host = next(iter(loader))
    batch = host_to_device_batch(host, dev)
    # each sparse conv layer's inputs and the gather-GEMM launches it made
    captured, launched, overlap_calls = [], [], []
    layers = [m for m in model.backbone_3d.modules()
              if type(m).__name__ == 'SparseConvLayer']
    hooks = [m.register_forward_pre_hook(lambda mod, args: captured.append(
        (mod, args[0], args[1], cuda_kernels.launches))) for m in layers]
    hooks += [m.register_forward_hook(lambda mod, args, out: launched.append(
        cuda_kernels.launches - captured[len(launched)][3])) for m in layers]
    torch.cuda.synchronize()
    cuda_kernels.launches = cuda_overlap.launches = 0
    with recording_overlap(overlap_calls):
        preds, rec = step(batch)
    torch.cuda.synchronize()
    counts = {'gather_gemm': cuda_kernels.launches,
              'overlap_bev': cuda_overlap.launches}
    for h in hooks:
        h.remove()
    log(f'main path launches: {counts}')
    for name, n in counts.items():
        if n == 0:
            raise RuntimeError(f'kernel {name} was not launched on the main path')
    if len(captured) != len(SPARSE_LAYERS):
        raise RuntimeError(f'expected {len(SPARSE_LAYERS)} sparse conv layers, '
                           f'saw {len(captured)}')
    if sum(launched) != counts['gather_gemm']:
        raise RuntimeError(f'gather-GEMM launches per layer {launched} '
                           f"do not add up to {counts['gather_gemm']}")
    if len(overlap_calls) != 2 or sum(c[2] for c in overlap_calls) != counts['overlap_bev']:
        raise RuntimeError(f'expected the overlap from the NMS and the recall '
                           f'record, saw {[(tuple(a.shape), n) for a, _, n in overlap_calls]}')

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
    n_iter = 5
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
    if not ((kept > 0).all() and (kept < alive).all()):
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
    log(f'eval step: {step_s * 1e3:.2f} ms/step mean of {n_iter}, '
        f'{BATCH / step_s:.2f} scans/s; boxes alive {alive.tolist()}, '
        f'kept {kept.tolist()}; max real voxels {max_real} of buffer {cap}; '
        f"recall record {', '.join(f'{k} {v.tolist()}' for k, v in rec.items())}")
    if max_real > cap:
        raise RuntimeError('voxel buffer truncates real voxels')
    stages = stage_ms(model, dataset, batch, cfg.MODEL.POST_PROCESSING,
                      len(cfg.CLASS_NAMES))
    log('eval step stages (ms, synchronised): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items())
        + f'; sum {sum(stages.values()):.2f}')
    profile_step(step, batch)

    # ---- each kernel against its plain version at the main path's inputs ----
    results = [time_gather_gemm(lname, layer, feats, rbk, n)
               for lname, (layer, feats, rbk, _), n
               in zip(SPARSE_LAYERS, captured, launched)]
    (nms_a, _, nms_n), (gt, pred, rec_n) = overlap_calls
    boxes = nms_a.clone()
    boxes[:, 1000:] = 0.0                               # degenerate rows
    if not (cuda_overlap.boxes_overlap_bev_cuda(boxes, boxes)[:, 1000:] == 0).all():
        raise RuntimeError('overlap: degenerate rows give non-zero areas')
    results.append(time_overlap('overlap_bev[nms]', boxes, boxes, nms_n, 'NMS'))
    results.append(time_overlap('overlap_bev[recall]', gt.contiguous(),
                                pred.contiguous(), rec_n, 'recall record'))

    check_reduced(dev)

    log(json.dumps({'kernels': results}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
