"""Strategy base: batched pool scoring on the device + selection bookkeeping.

Port of ``crb_active_3ddet_tpu/query_strategies/strategy.py`` (reference
``pcdet/query_strategies/strategy.py``: frame/info pairs :23-26,
``save_points`` :28-38, ``save_active_labels`` pickle layout :66-81, wandb
``update_dashboard`` :42-63).

``scan_pool`` runs one scoring function per batch that computes every
requested fixed-width per-frame signal on the model's device; strategies
then select on small host arrays.  XLA prunes the JAX scorer's unused
graph; eager PyTorch runs what it is given, so the scorer decides the same
things explicitly: no voxelisation and no forward when no requested signal
reads the model's output (``signals=()``: random's bookkeeping pass), and no
post-processing (the NMS) unless a requested signal reads the predictions.

The MC-dropout scorer (JAX ``strategy.py:113-151,189-206``) draws from one
``torch.Generator`` on the model's device, seeded ``MC_SEED`` once a scan
(the JAX scan's ``PRNGKey(0)``).  Its one-stage branch runs ``num_mc`` eval
forwards (SECOND draws nothing): the MC mean, the population variance
(``jnp.var``) of the sigmoid scores and of the boxes, and the logit of the
clipped mean as ``batch_cls_preds``, which the NMS then ranks.  On a model
with a RoI head one forward given the generator runs the MC rounds inside
the head (``pvrcnn_head.py``): ``mc_cls_var`` is the variance of the rounds'
sigmoid scores, ``mc_box_var`` that of the *encoded* ``rcnn_reg``,
``batch_rcnn_cls`` the mean of the sigmoid scores (B, R, 1) and
``batch_rcnn_reg`` the mean of ``rcnn_reg`` (CRB's stage-2 targets), while
the predictions that the NMS ranks are round 1's, under live Dropout.  Any
scan given a generator (BALD's single pass too) runs the head's rounds.
``loss_predictions`` is the LossNet's output and ``embeddings`` on a RoI
head with ``EMBEDDING_REQUIRED`` its ``shared_features``, (B, R·C); on a
one-stage model ``batch_rcnn_*`` and ``loss_predictions`` are accepted and
emit nothing, as in JAX.  There is no mesh: the sharded scorer is item 15.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading

import numpy as np
import torch

from ..datasets import _identity_attrs
from ..models import post_processing as pp
from ..runtime.train import (host_to_device_batch, points_valid_mask,
                             prepare_device_batch)

MC_SEED = 0            # the JAX scan's PRNGKey(0)


def _softmax_entropy(logits, valid=None):
    """Per-box softmax entropy → mean over the (valid) boxes of each frame.
    logits (B, P, C), valid (B, P) or None → (B,)."""
    logp = torch.log_softmax(logits, dim=-1)
    ent = -(torch.exp(logp) * logp).sum(-1)
    if valid is None:
        return ent.mean(-1)
    n = torch.clamp(valid.sum(-1), min=1)
    return torch.where(valid, ent, torch.zeros_like(ent)).sum(-1) / n


def _label_hist_entropy(labels, valid, num_class):
    """CRB stage 1: Shannon entropy of each frame's predicted label
    histogram.  Reference quirk (crb_sampling.py:86-93): absent classes get a
    pseudo-count of 1 before normalisation; frames without boxes score 0."""
    classes = torch.arange(1, num_class + 1, device=labels.device)
    onehot = ((labels[..., None] == classes) & valid[..., None]).to(torch.float32)
    hist = torch.clamp(onehot.sum(-2), min=1.0)
    p = hist / hist.sum(-1, keepdim=True)
    ent = -(p * torch.log(p)).sum(-1)
    return torch.where(valid.any(-1), ent, torch.zeros_like(ent))


class Strategy:
    #: signals read from the NMS'd predictions: without one of them the
    #: scorer runs no post-processing
    _PRED_SIGNALS = frozenset({'box_entropy', 'label_entropy', 'pred_density',
                               'pred_labels', 'pred_valid'})
    #: signals read from the model's output: without one of them the scorer
    #: runs no forward
    _MODEL_SIGNALS = _PRED_SIGNALS | {'confidence_entropy', 'embeddings',
                                      'mc_cls_var', 'mc_box_var', 'batch_rcnn_cls',
                                      'batch_rcnn_reg', 'loss_predictions'}

    def __init__(self, model, labelled_loader, unlabelled_loader, rank,
                 active_label_dir, cfg):
        self.cfg = cfg
        self.active_label_dir = active_label_dir
        self.rank = rank
        self.model = model
        self.labelled_loader = labelled_loader
        self.unlabelled_loader = unlabelled_loader
        self.labelled_set = labelled_loader.dataset
        self.unlabelled_set = unlabelled_loader.dataset
        self.class_names = list(cfg.CLASS_NAMES)
        self.num_class = len(self.class_names)
        self.bbox_records = {}
        self.point_measures = ['mean', 'median', 'variance']
        for met in self.point_measures:
            setattr(self, f'{met}_point_records', {})

        id_attr, info_attr = _identity_attrs(self.unlabelled_set)
        self.pairs = list(zip(getattr(self.unlabelled_set, id_attr),
                              getattr(self.unlabelled_set, info_attr)))
        self._score_fns = {}  # keyed on (mc_dropout, num_mc, signals)

    # ---- pool scoring ------------------------------------------------------
    def build_score_fn(self, mc_dropout: bool = False, num_mc: int = 0,
                       signals=None):
        """(device batch, generator) → per-frame signal dict of (B, ...)
        tensors, on the model's device, in eval mode, without autograd.

        ``signals``: the names to emit (None: every signal).  The per-frame
        gt statistics are always included (``save_points`` reads them).
        ``mc_dropout``: ``num_mc`` forwards (one when ``num_mc`` ≤ 1; one on a
        model with a RoI head, whose rounds run inside it), each drawing from
        the generator; ``mc_cls_var`` and ``mc_box_var`` come only from more
        than one."""
        want = None if signals is None else frozenset(signals)
        model = self.model
        post_cfg = self.cfg.MODEL.POST_PROCESSING
        num_class = self.num_class
        dataset = self.unlabelled_set
        geom = (dataset.voxel_cfg, tuple(int(g) for g in dataset.grid_size),
                tuple(float(x) for x in dataset.point_cloud_range),
                tuple(float(v) for v in dataset.voxel_size))

        def wanted(name):
            return want is None or name in want

        need_model = want is None or bool(want & self._MODEL_SIGNALS)
        need_preds = want is None or bool(want & self._PRED_SIGNALS)

        mc_rounds = int(num_mc) if mc_dropout and num_mc > 1 else 0

        def forward(batch, generator):
            if not mc_rounds:
                return model(batch, generator)
            # MC rounds: eval forwards, each drawing from the generator
            # (JAX strategy.py:133-146)
            out = model(batch, generator)
            if out.get('rcnn_cls') is not None and out['rcnn_cls'].ndim == 3:
                return two_stage(out)
            cls = [torch.sigmoid(out['batch_cls_preds'])]
            box = [out['batch_box_preds']]
            for _ in range(mc_rounds - 1):
                o = model(batch, generator)
                cls.append(torch.sigmoid(o['batch_cls_preds']))
                box.append(o['batch_box_preds'])
            mc_cls, mc_box = torch.stack(cls), torch.stack(box)   # (S, B, A, ·)
            # jnp.mean and jnp.var: the sum over the rounds over their number
            mean = mc_cls.sum(0) / mc_rounds
            out['mc_cls_mean'] = mean
            out['mc_cls_var'] = ((mc_cls - mean) ** 2).sum(0) / mc_rounds
            out['mc_box_var'] = ((mc_box - mc_box.sum(0) / mc_rounds) ** 2).sum(0) \
                / mc_rounds
            out['batch_cls_preds'] = torch.logit(torch.clamp(mean, 1e-6, 1 - 1e-6))
            return out

        def two_stage(out):
            # the head's rounds, (S, B·R, ·); the predictions stay round 1's
            # (JAX strategy.py:113-131)
            b = out['batch_cls_preds'].shape[0]
            mc_cls, reg = torch.sigmoid(out['rcnn_cls']), out['rcnn_reg']
            s = mc_cls.shape[0]
            mean, reg_mean = mc_cls.sum(0) / s, reg.sum(0) / s
            out['mc_cls_mean'] = mean.reshape(b, -1, 1)
            out['mc_cls_var'] = (((mc_cls - mean) ** 2).sum(0) / s).reshape(b, -1, 1)
            out['mc_box_var'] = (((reg - reg_mean) ** 2).sum(0) / s).reshape(
                b, -1, reg.shape[-1])
            out['batch_rcnn_cls'] = out['mc_cls_mean']
            out['batch_rcnn_reg'] = reg_mean.reshape(b, -1, reg.shape[-1])
            return out

        @torch.no_grad()
        def score(device_batch, generator=None):
            out = {}
            if need_model:
                model.eval()
                batch = prepare_device_batch(device_batch, *geom)
                out = forward(batch, generator)
                points, points_valid = batch['points'], batch['points_valid']
            else:
                points = device_batch['points']
                points_valid = points_valid_mask(points, device_batch['num_points'])
            preds = pp.post_processing(out, post_cfg, num_class=num_class) \
                if need_preds else None

            sig = {}
            if wanted('box_entropy'):
                sig['box_entropy'] = _softmax_entropy(preds['pred_logits'],
                                                      preds['pred_valid'])
            if wanted('label_entropy'):
                sig['label_entropy'] = _label_hist_entropy(
                    preds['pred_labels'], preds['pred_valid'], num_class)
            if wanted('confidence_entropy'):
                # all-anchor confidence entropy (confidence strategy)
                sig['confidence_entropy'] = _softmax_entropy(
                    torch.sigmoid(out['batch_cls_preds']))
            if wanted('pred_density'):
                sig['pred_density'] = preds['pred_box_unique_density']
            if wanted('pred_labels'):
                sig['pred_labels'] = preds['pred_labels']
            if wanted('pred_valid'):
                sig['pred_valid'] = preds['pred_valid']
            if mc_rounds:
                if wanted('mc_cls_var'):
                    sig['mc_cls_var'] = out['mc_cls_var'].mean(dim=(1, 2))
                if wanted('mc_box_var'):
                    sig['mc_box_var'] = out['mc_box_var'].mean(dim=(1, 2))
                if 'batch_rcnn_cls' in out and wanted('batch_rcnn_cls'):
                    sig['batch_rcnn_cls'] = out['batch_rcnn_cls']
                    sig['batch_rcnn_reg'] = out['batch_rcnn_reg']
            if 'loss_predictions' in out and wanted('loss_predictions'):
                sig['loss_predictions'] = out['loss_predictions'].reshape(-1)
            if wanted('embeddings'):
                if 'shared_features' in out:
                    sig['embeddings'] = out['shared_features'].reshape(
                        out['shared_features'].shape[0], -1)
                else:
                    # single-stage: mean-pooled BEV features, (B, H, W, C) → (B, C)
                    sig['embeddings'] = out['spatial_features_2d'].mean(dim=(1, 2))
            sig.update(pp.gt_class_stats(points, points_valid,
                                         device_batch['gt_boxes'], num_class))
            return sig

        return score

    def scan_pool(self, mc_dropout=False, num_mc=0, loader=None, signals=None):
        """Run the scorer over the whole unlabelled pool (or ``loader``).

        Returns dict frame_id (a plain str) → {signal: np.ndarray}, in pool
        order; a frame that a wrap-padded batch scored twice keeps its last
        record.  An MC-dropout scan draws from a generator on the model's
        device seeded ``MC_SEED``.  Every
        batch is dispatched first, then each signal is concatenated on the
        device and read back once; a one-batch-lookahead thread collates and
        moves the next batch meanwhile."""
        loader = loader if loader is not None else self.unlabelled_loader
        want = None if signals is None else frozenset(signals)
        key = (bool(mc_dropout), int(num_mc), want)
        if key not in self._score_fns:
            self._score_fns[key] = self.build_score_fn(mc_dropout, num_mc,
                                                       signals=want)
        score_fn = self._score_fns[key]
        device = self.model.device
        generator = torch.Generator(device=device).manual_seed(MC_SEED) \
            if mc_dropout else None
        q = queue.Queue(maxsize=2)

        def produce():
            try:
                for batch in loader:
                    q.put((batch['frame_id'], host_to_device_batch(batch, device)))
                q.put(None)
            except BaseException as e:  # surface loader errors to the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        pending = []
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            frame_ids, device_batch = item
            pending.append((frame_ids, score_fn(device_batch, generator)))
        t.join()
        records = {}
        if not pending:
            return records
        all_ids = [str(fid) for frame_ids, _ in pending for fid in frame_ids]
        keys = list(pending[0][1].keys())
        stacked = {k: torch.cat([sig[k] for _, sig in pending]).cpu().numpy()
                   for k in keys}
        for i, fid in enumerate(all_ids):
            records[fid] = {k: stacked[k][i] for k in keys}
            self.save_points(fid, records[fid])
        return records

    # ---- single frames (CRB's stage 2, BADGE's pass 2) ----------------------
    def grad_chunk(self):
        """Frames loaded and voxelized together: ``ACTIVE_TRAIN.GRAD_CHUNK``,
        else the pool loader's batch size, else 4."""
        return int(self.cfg.ACTIVE_TRAIN.get('GRAD_CHUNK', 0)) \
            or getattr(getattr(self.unlabelled_loader, 'batch_sampler', None),
                       'batch_size', None) \
            or getattr(self.unlabelled_loader, 'batch_size', None) or 4

    def _load_frames(self, frame_ids):
        ds = self.unlabelled_set
        ids = [str(p[0]) for p in self.pairs]
        return ds.collate_batch([ds[ids.index(str(f))] for f in frame_ids])

    def single_frames(self, frame_ids, drop=()):
        """Yields each frame's batch-1 model input, in order: ``grad_chunk()``
        frames are loaded, moved and voxelized together, then sliced; the
        keys in ``drop`` are left out."""
        dataset, device = self.unlabelled_set, self.model.device
        geom = (dataset.voxel_cfg, tuple(int(g) for g in dataset.grid_size),
                tuple(float(x) for x in dataset.point_cloud_range),
                tuple(float(v) for v in dataset.voxel_size))
        chunk = self.grad_chunk()
        for i0 in range(0, len(frame_ids), chunk):
            fids = frame_ids[i0:i0 + chunk]
            batch = prepare_device_batch(
                host_to_device_batch(self._load_frames(fids), device), *geom)
            for j in range(len(fids)):
                b1 = {k: v[j:j + 1] for k, v in batch.items()
                      if k != 'batch_size' and k not in drop}
                b1['batch_size'] = 1
                yield b1

    # ---- bookkeeping (reference-parity surfaces) ---------------------------
    def save_points(self, frame_id, record):
        as_dict = lambda arr: {c: float(np.asarray(arr)[i])
                               for i, c in enumerate(self.class_names)}
        self.bbox_records[frame_id] = as_dict(record['num_bbox'])
        self.mean_point_records[frame_id] = as_dict(record['mean_points'])
        self.median_point_records[frame_id] = as_dict(record['median_points'])
        self.variance_point_records[frame_id] = as_dict(record['variance_points'])

    def update_dashboard(self, cur_epoch=None, accumulated_iter=None,
                         metrics=None):
        """AL selection dashboard (parity: strategy.py:42-63 wandb panels).
        ``metrics``: any object with ``add_scalar(key, value, step)``; without
        one, a live wandb run if the package is there."""
        sinks = []
        if metrics is not None:
            sinks.append(metrics.add_scalar)
        else:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None and wandb.run is not None:
                sinks.append(lambda k, v, s: wandb.log({k: v}, step=s))
        if not sinks:
            return

        def log(key, value):
            for s in sinks:
                s(key, value, accumulated_iter)

        for k, v in getattr(self, 'stage_times', {}).items():
            log(f'active_timing/{k}', float(v))
        if not getattr(self, 'selected_bbox', None):
            return

        classes = list(self.selected_bbox[0].keys())
        total_bbox = 0
        for cls_idx in classes:
            num_cls_bbox = sum(i[cls_idx] for i in self.selected_bbox)
            log(f'active_selection/num_bbox_{cls_idx}', num_cls_bbox)
            total_bbox += num_cls_bbox
            for met in self.point_measures:
                sel = getattr(self, f'selected_{met}_points')
                val = (sum(i[cls_idx] for i in sel) / len(sel)) if num_cls_bbox else 0
                log(f'active_selection/{met}_points_{cls_idx}', val)
        log('active_selection/total_bbox_selected', total_bbox)

    def save_active_labels(self, selected_frames=None, grad_embeddings=None,
                           cur_epoch=None):
        """Pickle the selection in the JAX package's layout (plain str,
        float and list values), loadable by either package."""
        if selected_frames is not None:
            self.selected_bbox = [self.bbox_records[i] for i in selected_frames]
            for met in self.point_measures:
                setattr(self, f'selected_{met}_points',
                        [getattr(self, f'{met}_point_records')[i]
                         for i in selected_frames])
            path = os.path.join(
                self.active_label_dir,
                f'selected_frames_epoch_{cur_epoch}_rank_{self.rank}.pkl')
            with open(path, 'wb') as f:
                pickle.dump({
                    'frame_id': selected_frames,
                    'selected_mean_points': self.selected_mean_points,
                    'selected_bbox': self.selected_bbox,
                    'selected_median_points': self.selected_median_points,
                    'selected_variance_points': self.selected_variance_points,
                }, f)
        if grad_embeddings is not None:
            path = os.path.join(self.active_label_dir,
                                f'grad_embeddings_epoch_{cur_epoch}.pkl')
            with open(path, 'wb') as f:
                pickle.dump(grad_embeddings, f)

    def query(self, leave_pbar=True, cur_epoch=None):
        raise NotImplementedError
