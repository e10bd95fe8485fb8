"""CRB sampling, the paper's three-stage acquisition, on one-stage models.

Port of ``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:38
CRBSampling`` (reference ``pcdet/query_strategies/crb_sampling.py``):
  Stage 1 (JAX ``:58-78``), concise label sampling: the MC-dropout scan with
    the same signal set; each frame's label-histogram entropy; the top K1·N
    frames, ties in reverse pool order (``sorted`` then ``[::-1]``).
  Stage 2 (``:80-164``, ``:314-408``), representative prototypes: one
    gradient embedding a frame, then k-means++ (``kmeans_pp.py``) down to
    K2·N, de-duplicated and backfilled from the stage-1 ranking.  On a model
    with a RoI head (PV-RCNN) the gradient at ``roi_head.shared_fc_1`` (the
    second shared layer, Flax's name; flattened in the Flax kernel's (in,
    out) order) of the hypothetical cls loss plus the mean of the
    hypothetical reg loss against the frame's stage-1 MC means
    ``batch_rcnn_cls`` / ``batch_rcnn_reg``; the training RoIs are not the
    TEST RoIs those came from, and are paired with them by index, sliced to
    the shorter (JAX ``:368-385``).  On a one-stage model the gradient at
    ``dense_head.conv_cls.weight`` of the anchor head's focal cls loss
    against the frame's own argmax labels (the 0..C−1 quirk), flattened in
    the JAX kernel's (1, 1, Cin, A·C) order.
  Stage 3 (``:173-311``), greedy point density balancing (GPDB): a per-class
    uniform prior over the [5 %, 95 %] density support on a 400-point grid;
    greedily the frame whose per-class Gaussian KDE of the accumulated box
    densities maximises mean(1 − (2/π)·arctan(π/2·KL(uniform ‖ KDE))).

Stage 2 runs each frame alone in training mode, as the JAX ``grad_fn``'s
batch-1 ``training=True`` forward with live Dropout does: BatchNorm
normalises with that frame's statistics; on a RoI head the forward reads the
frame's ``gt_boxes`` (the proposal targets sample the RoIs) and draws from a
generator seeded ``GRAD_SEED``.  The JAX package differentiates only the
one kernel, so XLA runs the rest forward only; here every other parameter
is held out of autograd during the frame's forward (the one-stage head's
conv is recomputed from the BEV features).  The JAX forward throws its
updated BN statistics away (``mutable=['batch_stats']``); the port's
BatchNorms update theirs in place, so every buffer is copied before and
written back after, and the modules' training flags and the parameters'
``requires_grad`` are restored.  The clusterings that need scikit-learn's
estimators (``kmeans``, ``birch``, ``gmm``) come with ROADMAP Queue 1 item
12c.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.special
import scipy.stats
import torch

from ..models.dense_heads import anchor_head_single as ahs
from ..models.roi_heads import roi_head_template as rht
from ..utils import common
from .kmeans_pp import kmeans_plusplus
from .strategy import Strategy

GRAD_SEED = 1          # the JAX stage 2's PRNGKey(1)
_LATER = 'ROADMAP Queue 1 item 12c'
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
        # the RoI head's hypothetical targets: stage 1's MC means
        targets = {fid: (r['batch_rcnn_cls'], r['batch_rcnn_reg'])
                   for fid, r in records.items() if 'batch_rcnn_cls' in r}
        start = time.time()
        embeddings = self.grad_embeddings(k1_frames, targets) if targets \
            else self.grad_embeddings(k1_frames)
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
    def grad_embeddings(self, frame_ids, targets=None):
        """(len(frame_ids), D) float32: each frame's gradient embedding from a
        batch-1 training-mode forward (the JAX ``_build_grad_fn``): with a
        RoI head, at ``shared_fc_1`` against ``targets`` {frame id:
        (batch_rcnn_cls, batch_rcnn_reg)}; else at ``conv_cls`` against the
        frame's argmax labels.  The model's parameters, buffers, training
        flags and ``requires_grad`` are as before."""
        model = self.model
        two_stage = hasattr(model, 'roi_head')
        if two_stage and targets is None:
            raise ValueError('stage 2 over a RoI head needs the stage-1 targets')
        generator = torch.Generator(device=model.device).manual_seed(GRAD_SEED)
        flags = [(m, m.training) for m in model.modules()]
        saved = [(b, b.clone()) for b in model.buffers()]
        wanted = [(p, p.requires_grad) for p in model.parameters()]
        grads = []
        try:
            model.train()
            if two_stage:
                # only the gradient's own weight, Flax's shared_fc_1 (the
                # second shared layer), enters autograd
                weight = [m for m in model.roi_head.shared_fc_layer
                          if isinstance(m, torch.nn.Conv1d)][1].weight
                for p, _ in wanted:
                    p.requires_grad_(p is weight)
            # a one-stage head's targets are not read: no gt_boxes
            drop = () if two_stage else ('gt_boxes',)
            for fid, b1 in zip(frame_ids, self.single_frames(frame_ids, drop)):
                if two_stage:
                    with torch.enable_grad():
                        out = model(b1, generator)
                        grads.append(shared_fc_grad(out, weight, *targets[fid]))
                else:
                    with torch.no_grad():
                        out = model(b1, generator)
                    labels = out['cls_preds'].reshape(1, -1, self.num_class).argmax(-1)
                    grads.append(cls_weight_grad(model.dense_head, out, labels))
        finally:
            with torch.no_grad():
                for buf, value in saved:
                    buf.copy_(value)
            for m, training in flags:
                m.training = training
            for p, req in wanted:
                p.requires_grad_(req)
        return torch.stack(grads).cpu().numpy()

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


def shared_fc_grad(out, weight, hyp_cls, hyp_reg):
    """A training forward's hypothetical loss (JAX ``crb_sampling.py:368-385``:
    the cls loss plus the mean of the reg loss against the stage-1 MC means,
    the training RoIs paired with the TEST ones by index, sliced to the
    shorter) differentiated at the shared layer's ``weight`` (out, in, 1),
    flattened in the Flax kernel's (in, out) order."""
    dev = out['rcnn_cls'].device
    pred_cls = out['rcnn_cls'].reshape(-1)
    tgt_cls = torch.from_numpy(np.array(hyp_cls, np.float32)).to(dev).reshape(-1)
    r = min(pred_cls.shape[0], tgt_cls.shape[0])
    code = out['rcnn_reg'].shape[-1]
    pred_reg = out['rcnn_reg'].reshape(-1, code)
    tgt_reg = torch.from_numpy(np.array(hyp_reg, np.float32)).to(dev).reshape(-1, code)
    rr = min(pred_reg.shape[0], tgt_reg.shape[0])
    with common.full_f32():
        loss = rht.get_box_cls_layer_loss_hyp(pred_cls[:r], tgt_cls[:r]) \
            + rht.get_box_reg_layer_loss_hyp(pred_reg[:rr], tgt_reg[:rr]).mean()
        (grad,) = torch.autograd.grad(loss, weight)
    return grad[:, :, 0].t().reshape(-1)


def cls_weight_grad(head, out, labels):
    """The anchor head's focal cls loss against ``labels`` (1, A) at
    ``conv_cls.weight``, for one frame's forward ``out``, flattened in the
    Flax kernel's (1, 1, Cin, A·C) order."""
    conv = head.conv_cls
    weight = conv.weight.detach().requires_grad_()
    params = {'weight': weight, 'bias': conv.bias.detach()}
    with torch.enable_grad(), common.full_f32():
        cls = head._conv_nhwc(lambda x: torch.func.functional_call(conv, params, (x,)),
                              out['spatial_features_2d'])
        loss = ahs.get_cls_layer_loss(out, head, new_data={
            'cls_preds': cls, 'box_cls_labels': labels})
        (grad,) = torch.autograd.grad(loss, weight)
    return grad.permute(2, 3, 1, 0).reshape(-1)      # (A·C, Cin, 1, 1) → (1, 1, Cin, A·C)
