"""CRB sampling, the paper's three-stage acquisition, on one-stage models.

Port of ``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:38
CRBSampling`` (reference ``pcdet/query_strategies/crb_sampling.py``):
  Stage 1 (JAX ``:58-78``), concise label sampling: the MC-dropout scan with
    the same signal set; each frame's label-histogram entropy; the top K1·N
    frames, ties in reverse pool order (``sorted`` then ``[::-1]``).
  Stage 2 (``:90-164``), representative prototypes: one gradient embedding a
    frame, the gradient of the anchor head's focal cls loss against the
    frame's own argmax labels (the 0..C−1 quirk) with respect to
    ``dense_head.conv_cls.weight``, flattened in the JAX kernel's
    (1, 1, Cin, A·C) order; then k-means++ (``kmeans_pp.py``) down to K2·N,
    de-duplicated and backfilled from the stage-1 ranking.
  Stage 3 (``:173-311``), greedy point density balancing (GPDB): a per-class
    uniform prior over the [5 %, 95 %] density support on a 400-point grid;
    greedily the frame whose per-class Gaussian KDE of the accumulated box
    densities maximises mean(1 − (2/π)·arctan(π/2·KL(uniform ‖ KDE))).

Stage 2 runs each frame alone in training mode, as the JAX ``grad_fn``'s
batch-1 ``training=True`` forward does: BatchNorm normalises with that
frame's statistics.  The JAX package differentiates only the head's kernel,
so XLA runs the backbone forward only; here the frame's forward runs under
``no_grad`` and autograd takes the 1×1 ``conv_cls`` alone.  The JAX forward
throws its updated BN statistics away (``mutable=['batch_stats']``); the
port's BatchNorms update theirs in place, so every buffer is copied before
and written back after, and the modules' training flags are restored.  The
RoI head's stage 2 (``:368-385``, hypothetical targets at
``shared_fc_1``) and the clusterings that need scikit-learn's estimators
(``kmeans``, ``birch``, ``gmm``) come with ROADMAP Queue 1 item 12b.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.special
import scipy.stats
import torch

from ..models.dense_heads import anchor_head_single as ahs
from ..runtime.train import host_to_device_batch, prepare_device_batch
from ..utils import common
from .kmeans_pp import kmeans_plusplus
from .strategy import Strategy

GRAD_SEED = 1          # the JAX stage 2's PRNGKey(1)
_LATER = 'ROADMAP Queue 1 item 12b'
_STAGE1_SIGNALS = ('label_entropy', 'pred_density', 'pred_labels', 'pred_valid',
                   'batch_rcnn_cls', 'batch_rcnn_reg')


class CRBSampling(Strategy):
    def __init__(self, model, labelled_loader, unlabelled_loader, rank,
                 active_label_dir, cfg):
        super().__init__(model, labelled_loader, unlabelled_loader, rank,
                         active_label_dir, cfg)
        active_cfg = cfg.ACTIVE_TRAIN.get('ACTIVE_CONFIG', {})
        self.k1 = active_cfg.get('K1', 5)
        self.k2 = active_cfg.get('K2', 3)
        # the reference's config key says BANDWDITH (crb_sampling.py:30)
        self.bandwidth = active_cfg.get('BANDWDITH', active_cfg.get('BANDWIDTH', 5))
        self.prototype = active_cfg.get('CLUSTERING', 'kmeans++')
        self.alpha = 0.95
        if self.prototype in ('kmeans', 'birch', 'gmm'):
            raise NotImplementedError(f'CLUSTERING {self.prototype!r} needs scikit-learn\'s '
                                      f'estimator; it comes with {_LATER}')
        if self.prototype != 'kmeans++':
            raise NotImplementedError(self.prototype)

    def query(self, leave_pbar=True, cur_epoch=None):
        num_class = self.num_class
        n_select = int(self.cfg.ACTIVE_TRAIN.SELECT_NUMS)

        # ---------------- Stage 1: concise label sampling ----------------
        t_stage1 = time.time()
        num_mc = int(self.cfg.MODEL.get('SAMPLING_ROUND', 5))
        records = self.scan_pool(mc_dropout=True, num_mc=num_mc,
                                 signals=_STAGE1_SIGNALS)
        select_dic = {fid: float(r['label_entropy']) for fid, r in records.items()}
        density_list = {fid: r['pred_density'][r['pred_valid']]
                        for fid, r in records.items()}
        label_list = {fid: r['pred_labels'][r['pred_valid']]
                      for fid, r in records.items()}
        ranked = sorted(select_dic.items(), key=lambda kv: kv[1])
        k1_frames = [fid for fid, _ in ranked[::-1][:int(self.k1 * n_select)]]
        self.stage_times = {'crb_stage1_s': time.time() - t_stage1}

        # ---------------- Stage 2: representative prototypes -------------
        start = time.time()
        embeddings = self.grad_embeddings(k1_frames)
        n_k2 = int(n_select * self.k2)
        sel_idx = kmeans_plusplus(embeddings, n_clusters=n_k2, random_state=0)
        k2_frames = [k1_frames[i] for i in sel_idx]
        # a centre picker can return one frame twice when embeddings
        # collapse: de-dup in cluster order, backfill from the stage-1 ranking
        seen = set()
        k2_frames = [f for f in k2_frames if not (f in seen or seen.add(f))]
        for f in k1_frames:
            if len(k2_frames) >= n_k2:
                break
            if f not in seen:
                seen.add(f)
                k2_frames.append(f)
        self.stage_times['crb_stage2_s'] = time.time() - start

        # ---------------- Stage 3: greedy density balancing (GPDB) -------
        t_stage3 = time.time()
        out = self._gpdb(k2_frames, density_list, label_list, num_class, n_select)
        self.stage_times['crb_stage3_s'] = time.time() - t_stage3
        return out

    # ---- stage 2 ----------------------------------------------------------
    def grad_chunk(self):
        """Frames loaded and voxelized together: ``ACTIVE_TRAIN.GRAD_CHUNK``,
        else the pool loader's batch size, else 4."""
        return int(self.cfg.ACTIVE_TRAIN.get('GRAD_CHUNK', 0)) \
            or getattr(getattr(self.unlabelled_loader, 'batch_sampler', None),
                       'batch_size', None) \
            or getattr(self.unlabelled_loader, 'batch_size', None) or 4

    def grad_embeddings(self, frame_ids):
        """(len(frame_ids), Cin·A·C) float32: each frame's gradient of the
        focal cls loss against its argmax labels with respect to
        ``conv_cls.weight``, from a batch-1 training-mode forward (parity:
        the JAX ``_build_grad_fn``'s single-stage branch).  The model's
        parameters, buffers and training flags are as before."""
        model = self.model
        if hasattr(model, 'roi_head'):
            raise NotImplementedError('stage 2 over the RoI head (hypothetical '
                                      f'targets at shared_fc_1) comes with {_LATER}')
        dataset = self.unlabelled_set
        geom = (dataset.voxel_cfg, tuple(int(g) for g in dataset.grid_size),
                tuple(float(x) for x in dataset.point_cloud_range),
                tuple(float(v) for v in dataset.voxel_size))
        chunk = self.grad_chunk()
        generator = torch.Generator(device=model.device).manual_seed(GRAD_SEED)
        flags = [(m, m.training) for m in model.modules()]
        saved = [(b, b.clone()) for b in model.buffers()]
        grads = []
        try:
            model.train()
            for i0 in range(0, len(frame_ids), chunk):
                fids = frame_ids[i0:i0 + chunk]
                batch = prepare_device_batch(
                    host_to_device_batch(self._load_frames(fids), model.device), *geom)
                for j in range(len(fids)):
                    # the head's targets are not read: no gt_boxes
                    b1 = {k: v[j:j + 1] for k, v in batch.items()
                          if k not in ('batch_size', 'gt_boxes')}
                    b1['batch_size'] = 1
                    with torch.no_grad():
                        out = model(b1, generator)
                    grads.append(self._cls_weight_grad(out))
        finally:
            with torch.no_grad():
                for buf, value in saved:
                    buf.copy_(value)
            for m, training in flags:
                m.training = training
        return torch.stack(grads).cpu().numpy()

    def _cls_weight_grad(self, out):
        """The focal cls loss's gradient at ``conv_cls.weight`` for one
        frame's forward ``out``, flattened in the Flax kernel's order."""
        head = self.model.dense_head
        conv = head.conv_cls
        labels = out['cls_preds'].reshape(1, -1, self.num_class).argmax(-1)
        weight = conv.weight.detach().requires_grad_()
        params = {'weight': weight, 'bias': conv.bias.detach()}
        with torch.enable_grad(), common.full_f32():
            cls = head._conv_nhwc(lambda x: torch.func.functional_call(conv, params, (x,)),
                                  out['spatial_features_2d'])
            loss = ahs.get_cls_layer_loss(out, head, new_data={
                'cls_preds': cls, 'box_cls_labels': labels})
            (grad,) = torch.autograd.grad(loss, weight)
        return grad.permute(2, 3, 1, 0).reshape(-1)      # (A·C, Cin, 1, 1) → (1, 1, Cin, A·C)

    def _load_frames(self, frame_ids):
        ds = self.unlabelled_set
        ids = [str(p[0]) for p in self.pairs]
        return ds.collate_batch([ds[ids.index(str(f))] for f in frame_ids])

    # ---- stage 3 ----------------------------------------------------------
    def _gpdb(self, k2_frames, density_list, label_list, num_class, n_select):
        """Parity: JAX ``crb_sampling.py:173-199``."""
        x_axis, uniform_dist_per_cls = self._gpdb_prior(density_list, label_list,
                                                        num_class)
        dl = [np.asarray(density_list[f]) for f in k2_frames]
        ll = [np.asarray(label_list[f]) for f in k2_frames]
        fids = list(k2_frames)
        if self.cfg.ACTIVE_TRAIN.get('GPDB_DEVICE', True) and len(fids):
            return self._gpdb_greedy_device(fids, dl, ll, x_axis, uniform_dist_per_cls,
                                            num_class, n_select)
        return self._gpdb_greedy_host(fids, dl, ll, x_axis, uniform_dist_per_cls,
                                      num_class, n_select)

    def _gpdb_prior(self, density_list, label_list, num_class):
        """Each class's 400-point grid and its uniform prior over the [5 %,
        95 %] support of the pool's densities, at integer bounds (``[0, 1]``
        for a class without a box).  When the two bounds meet, the prior's
        support is 1e-6 wide and may miss every grid point: the host oracle's
        KL is then NaN, in the JAX package too."""
        density_all = np.concatenate(list(density_list.values()))
        label_all = np.concatenate(list(label_list.values()))
        x_axis, uniform_dist_per_cls = [], []
        for cls in range(num_class):
            d = np.sort(density_all[label_all == cls + 1])
            if len(d) == 0:
                d = np.asarray([0.0, 1.0])
            d_max = int(d[-1])
            hi_idx = min(int(self.alpha * len(d)), len(d) - 1)
            lo = int(d[-max(int(self.alpha * len(d)), 1)])
            hi = int(d[hi_idx])
            xs = np.linspace(-50, d_max + 50, 400)
            x_axis.append(xs)
            uniform_dist_per_cls.append(scipy.stats.uniform.pdf(xs, lo, max(hi - lo, 1e-6)))
        return x_axis, uniform_dist_per_cls

    def _gpdb_greedy_host(self, fids, dl, ll, x_axis, uniform_dist_per_cls,
                          num_class, n_select):
        """The reference-shaped host loop, the oracle of the device form
        (JAX ``:201-240``): a Gaussian KDE per candidate and class.  The
        KDE's log density is written out (scikit-learn's
        ``KernelDensity(kernel='gaussian').score_samples``: the log of the
        mean of the normal densities of bandwidth h); the KL is
        ``scipy.stats.entropy``.  Consumes its lists."""
        h = float(self.bandwidth)
        log_norm = np.log(h * np.sqrt(2 * np.pi))
        selected_frames = []
        sel_densities = np.zeros((0,), np.float64)
        sel_labels = np.zeros((0,), np.int64)
        for j in range(n_select):
            if not fids:
                break
            if j == 0:
                best = 0
            else:
                best, best_coff = None, -1.0
                for i in range(len(fids)):
                    props = np.zeros(num_class)
                    for cls in range(num_class):
                        frame_cls_mask = ll[i] == cls + 1
                        if frame_cls_mask.sum() == 0:
                            props[cls] = 1.0
                            continue
                        dens_cls = np.concatenate([sel_densities[sel_labels == cls + 1],
                                                   dl[i][frame_cls_mask]])
                        z = (x_axis[cls][:, None] - dens_cls[None, :]) / h
                        logprob = scipy.special.logsumexp(-0.5 * z * z, axis=1) \
                            - np.log(len(dens_cls)) - log_norm
                        kl = scipy.stats.entropy(uniform_dist_per_cls[cls], np.exp(logprob))
                        props[cls] = 2 / np.pi * np.arctan(np.pi / 2 * kl)
                    coff = float(np.mean(1 - props))
                    if coff > best_coff:
                        best_coff, best = coff, i
            selected_frames.append(fids[best])
            sel_densities = np.concatenate([sel_densities, dl[best]])
            sel_labels = np.concatenate([sel_labels, ll[best]])
            del dl[best], ll[best], fids[best]
        return selected_frames

    def _gpdb_greedy_device(self, fids, dl, ll, x_axis, uniform_dist_per_cls,
                            num_class, n_select):
        """The batched KDE on the model's device in f32 (JAX ``:242-311``):
        each greedy round scores every candidate's per-class Gaussian KDE on
        the 400-point grid in one pass.  KL(uniform ‖ kde) over the grid's
        normalised densities, so the KDE's constant cancels as in
        ``scipy.stats.entropy``."""
        device = self.model.device
        n_cand = len(fids)
        d_max = max(1, max(len(d) for d in dl))
        cand_dens = np.zeros((n_cand, num_class, d_max), np.float32)
        cand_cnt = np.zeros((n_cand, num_class), np.int64)
        for i, (dens, labs) in enumerate(zip(dl, ll)):
            for cls in range(num_class):
                d = dens[labs == cls + 1]
                cand_dens[i, cls, :len(d)] = d
                cand_cnt[i, cls] = len(d)
        sel_cap = max(1, n_select * d_max)
        f32 = dict(dtype=torch.float32, device=device)
        xs = torch.as_tensor(np.stack(x_axis), **f32)                  # (C, 400)
        pk = np.stack(uniform_dist_per_cls)
        pk = torch.as_tensor(pk / np.maximum(pk.sum(-1, keepdims=True), 1e-30), **f32)
        inv2h2 = 1.0 / (2.0 * float(self.bandwidth) ** 2)

        def ksum(dens, cnt):
            """Kernel sums on the grid: dens (..., C, S), cnt (..., C) →
            (..., C, 400)."""
            live = torch.arange(dens.shape[-1], device=device) < cnt[..., None]
            e = torch.exp(-(xs[:, :, None] - dens[..., :, None, :]) ** 2 * inv2h2)
            return (e * live[..., None, :]).sum(-1)

        cands = torch.as_tensor(cand_dens, **f32)
        ccnt = torch.as_tensor(cand_cnt, device=device)
        cand_k = ksum(cands, ccnt)                                     # (N, C, 400)
        sel_dens = np.zeros((num_class, sel_cap), np.float32)
        sel_cnt = np.zeros((num_class,), np.int64)
        alive = np.ones((n_cand,), bool)
        selected_frames = []
        for j in range(min(n_select, n_cand)):
            if j == 0:
                best = 0
            else:
                sel_k = ksum(torch.as_tensor(sel_dens, **f32),
                             torch.as_tensor(sel_cnt, device=device))  # (C, 400)
                total = cand_k + sel_k[None]
                qk = total / torch.clamp(total.sum(-1, keepdim=True), min=1e-30)
                ratio = torch.where(pk[None] > 0, pk[None] / torch.clamp(qk, min=1e-30),
                                    torch.ones_like(qk))
                kl = (pk[None] * torch.log(ratio)).sum(-1)              # (N, C)
                props = torch.where(ccnt > 0, 2 / np.pi * torch.atan(np.pi / 2 * kl),
                                    torch.ones_like(kl))
                coffs = (1.0 - props).mean(-1)
                coffs = torch.where(torch.as_tensor(alive, device=device), coffs,
                                    torch.full_like(coffs, -np.inf))
                best = int(np.argmax(coffs.cpu().numpy()))
            for cls in range(num_class):
                n = cand_cnt[best, cls]
                if n:
                    s = sel_cnt[cls]
                    take = min(n, sel_cap - s)
                    sel_dens[cls, s:s + take] = cand_dens[best, cls, :take]
                    sel_cnt[cls] = s + take
            alive[best] = False
            selected_frames.append(fids[best])
        return selected_frames
