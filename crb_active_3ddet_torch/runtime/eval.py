"""Evaluation loop (torch). Port of ``make_eval_step`` and ``eval_one_epoch``
from ``crb_active_3ddet_tpu/runtime/eval.py`` (reference
``tools/eval_utils/eval_utils.py:53-154``): fixed-shape forward + NMS on the
device, per-frame annos and AP on the host (``utils/simple_eval.py`` through
``dataset.evaluation``).  ``eval_one_epoch`` keeps the JAX loop's window of
8 dispatched batches before it reads the oldest one back.
"""

from __future__ import annotations

import time

import torch

from ..models import post_processing as pp
from .train import host_to_device_batch, prepare_device_batch

EVAL_WINDOW = 8     # batches in flight (the JAX loop's window)


def make_eval_step(model, dataset, post_cfg, num_class):
    """Returns ``eval_step(device_batch) -> (preds, recall_record)``; the
    model runs in eval mode under ``torch.no_grad`` on its own device."""
    voxel_cfg = dataset.voxel_cfg
    grid_size = tuple(int(g) for g in dataset.grid_size)
    pcr = tuple(float(x) for x in dataset.point_cloud_range)
    vs = tuple(float(v) for v in dataset.voxel_size)

    @torch.no_grad()
    def eval_step(host_batch):
        model.eval()            # the model may have trained since
        batch = prepare_device_batch(host_batch, voxel_cfg, grid_size, pcr, vs)
        out = model(batch)
        preds = pp.post_processing(out, post_cfg, num_class=num_class)
        rec = None
        if 'gt_boxes' in batch:
            gt = batch['gt_boxes']
            gt_valid = torch.abs(gt).sum(-1) > 0
            rec = pp.generate_recall_record(
                preds['pred_boxes'], preds['pred_valid'], gt[..., :7], gt_valid)
        return preds, rec

    return eval_step


def eval_one_epoch(eval_step, dataset, loader, class_names, device='cuda',
                   logger=None, result_dir=None, save_result_pkl=True):
    """Returns (ap_result_str, ap_dict, recall_dict); dumps result.pkl into
    result_dir (parity: eval_utils.py writes det_annos)."""
    det_annos = []
    recall_acc = {}
    num_frames = 0
    t0 = time.time()

    def drain(entry):
        nonlocal num_frames
        batch, preds, rec = entry
        preds = {k: v.cpu().numpy() for k, v in preds.items()}
        det_annos.extend(dataset.generate_prediction_dicts(
            batch, preds, class_names, output_path=result_dir))
        num_frames += batch['batch_size']
        if rec is not None:
            for k, v in rec.items():
                recall_acc[k] = recall_acc.get(k, 0) + int(v.sum())

    # keep a window of dispatched batches in flight, so that the host's anno
    # conversion of one batch overlaps the next batches' device work
    window = []
    for batch in loader:
        preds, rec = eval_step(host_to_device_batch(batch, device))
        window.append((batch, preds, rec))
        if len(window) >= EVAL_WINDOW:
            drain(window.pop(0))
    for entry in window:
        drain(entry)
    sec_per_example = (time.time() - t0) / max(num_frames, 1)
    if logger is not None:
        logger.info('Eval: %d frames, %.4f s/frame', num_frames, sec_per_example)
        gt_cnt = max(recall_acc.get('gt', 1), 1)
        for k, v in sorted(recall_acc.items()):
            if k != 'gt':
                logger.info('recall %s: %.4f', k, v / gt_cnt)
    if result_dir is not None and save_result_pkl:
        import pickle
        from pathlib import Path
        Path(result_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(result_dir) / 'result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)
    ap_result_str, ap_dict = dataset.evaluation(det_annos, class_names)
    ap_dict = dict(ap_dict or {})
    ap_dict['sec_per_example'] = sec_per_example
    return ap_result_str, ap_dict, recall_acc

