"""Active-learning training loop (torch).

Port of ``select_active_labels``, ``resume_dataset`` and
``train_model_active`` from ``crb_active_3ddet_tpu/runtime/active.py``
(reference ``tools/train_utils/train_active_utils.py`` train_model_active
:85-376 — save init weights, pretrain, selection rounds, reset to the init
weights and retrain each round — and ``pcdet/utils/active_training_utils.py``
select_active_labels :240-325).

The model is an ``nn.Module`` that holds its weights, so the JAX
``variables`` argument is gone; the loop runs on ``device`` (CUDA unless the
caller asks for the CPU).  The dropout key ``PRNGKey(666)`` is a
``torch.Generator`` on the device seeded 666.  The init weights are the JAX
model's own initializers (``flax_init``), drawn from a generator seeded 0
where JAX draws from ``PRNGKey(0)``.  Checkpoints use the port's
``.pth`` suffix; the selection pickles keep the JAX package's ``.pkl``
layout.  Every parameter and BatchNorm statistic is checked finite after the
pretrain and after each round, so that a diverged phase raises instead of
training on.  A one-cycle schedule over ≤ 2 steps, NaN at every count (where
the JAX loop trains a NaN model), already raises where ``torch.optim`` is
given its first lr.

With METHOD llal and a LossNet (``MODEL.ROI_HEAD.LOSS_NET``) each round first
fits the LossNet for ``LOSS_NET_TRAIN_EPOCH`` epochs over the labelled pool
(JAX ``active.py:80-156``; reference ``train_active_utils.py:242-296``), on a
fresh optimizer of that length: a training forward, the margin-ranking loss
of the predicted against the true per-frame losses, the backward to every
parameter, every gradient outside ``loss_net`` multiplied by 0 (the JAX
mask), then the clip and the update.  That is not a freeze: AdamW's decoupled
weight decay still moves every parameter, and the forward's BN statistics
are kept.
"""

from __future__ import annotations

import glob
import pickle
import re
from pathlib import Path

import torch

from ..datasets import build_active_dataloader, _identity_attrs, loader_batch_size
from ..models.detectors import build_detector, flax_init
from ..query_strategies import build_strategy
from ..utils import common, loss_utils
from ..utils.common import resolve_device
from . import checkpoint as ckpt_rt
from . import train as train_rt
from .optimization import build_optimizer

INIT_SEED = 0          # the JAX init_train_state's PRNGKey(0)
DROPOUT_SEED = 666     # the JAX loop's PRNGKey(666)


def _split(labelled_loader, unlabelled_loader, selected):
    """(sel_ids, sel_infos, unsel_ids, unsel_infos) after moving the
    ``selected`` frames from the unlabelled pool to the labelled one."""
    lab, unlab = labelled_loader.dataset, unlabelled_loader.dataset
    id_attr, info_attr = _identity_attrs(unlab)
    sel_ids = list(getattr(lab, id_attr))
    sel_infos = list(getattr(lab, info_attr))
    unsel_ids, unsel_infos = [], []
    for fid, info in zip(getattr(unlab, id_attr), getattr(unlab, info_attr)):
        if fid in selected:
            sel_ids.append(fid)
            sel_infos.append(info)
        else:
            unsel_ids.append(fid)
            unsel_infos.append(info)
    return tuple(sel_ids), tuple(sel_infos), tuple(unsel_ids), tuple(unsel_infos)


def _rebuild(cfg, labelled_loader, unlabelled_loader, selected, logger):
    """Both loaders (at the labelled loader's batch size and workers) over
    the split with ``selected`` moved; returns (labelled_loader,
    unlabelled_loader)."""
    (_, _, labelled, unlabelled, _, _) = build_active_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, loader_batch_size(labelled_loader), False,
        workers=labelled_loader.num_workers, logger=logger, training=True,
        active_training=_split(labelled_loader, unlabelled_loader, selected))
    return labelled, unlabelled


def select_active_labels(model, labelled_loader, unlabelled_loader, rank,
                         logger, method, cur_epoch=None, dist_train=False,
                         active_label_dir=None, cfg=None, tb_log=None):
    """Parity: ``active_training_utils.select_active_labels:240-325``: the
    round's pickle if it exists, else the strategy's query on ``model``'s
    device.  Returns (labelled_loader, unlabelled_loader, selected_frames)."""
    resume_path = Path(active_label_dir) / \
        f'selected_frames_epoch_{cur_epoch}_rank_{rank}.pkl'
    if resume_path.exists():
        with open(resume_path, 'rb') as f:
            selected_frames = pickle.load(f)['frame_id']
        logger.info('found and resumed %s', resume_path)
    else:
        strategy = build_strategy(method, model, labelled_loader,
                                  unlabelled_loader, rank, active_label_dir, cfg)
        selected_frames = list(strategy.query(cur_epoch=cur_epoch))
        strategy.save_active_labels(selected_frames=selected_frames,
                                    cur_epoch=cur_epoch)
        strategy.update_dashboard(cur_epoch=cur_epoch,
                                  accumulated_iter=cur_epoch, metrics=tb_log)
    labelled_loader, unlabelled_loader = _rebuild(
        cfg, labelled_loader, unlabelled_loader, selected_frames, logger)
    return labelled_loader, unlabelled_loader, selected_frames


def resume_dataset(labelled_loader, unlabelled_loader, active_label_dir,
                   cfg, logger, rank=0):
    """Re-apply every pickled selection round, in epoch order, to rebuild the
    split after a restart (parity: ``train_utils.resume_datset`` (sic)
    :178-246).  Returns (labelled_loader, unlabelled_loader, rounds_applied)."""
    pkls = sorted(
        glob.glob(str(Path(active_label_dir)
                      / f'selected_frames_epoch_*_rank_{rank}.pkl')),
        key=lambda p: int(re.search(r'epoch_(\d+)_', p).group(1)))
    for pkl_path in pkls:
        with open(pkl_path, 'rb') as f:
            selected = set(pickle.load(f)['frame_id'])
        labelled_loader, unlabelled_loader = _rebuild(
            cfg, labelled_loader, unlabelled_loader, selected, logger)
    if pkls and logger is not None:
        logger.info('resume_dataset: replayed %d selection rounds '
                    '(labelled pool %d)', len(pkls), len(labelled_loader.dataset))
    return labelled_loader, unlabelled_loader, len(pkls)


def _in_loss_net(name):
    """Whether parameter ``name`` lies in the RoI head's LossNet (the JAX
    ``_loss_net_mask``)."""
    return 'loss_net' in name.split('.')


def make_lossnet_train_step(model, optimizer, dataset):
    """The LossNet-only step (JAX ``make_lossnet_train_step``): ``step(state,
    device_batch, generator)`` → (state, {'loss': margin-ranking loss}).
    The true per-frame losses are the forward's ``compute_loss(reduce=False)``,
    held out of the gradient; the gradients outside ``loss_net`` are
    multiplied by 0 (a parameter that the loss does not reach gets a zero
    gradient, as in JAX), so that only weight decay moves those."""
    geom = (dataset.voxel_cfg, tuple(int(g) for g in dataset.grid_size),
            tuple(float(x) for x in dataset.point_cloud_range),
            tuple(float(v) for v in dataset.voxel_size))

    def step(state, device_batch, generator=None):
        model.train()
        out = model(train_rt.prepare_device_batch(device_batch, *geom), generator)
        per_frame, _ = model.compute_loss(out, reduce=False)
        loss = loss_utils.loss_pred_loss(out['loss_predictions_train'], per_frame.detach())
        optimizer.zero_grad()
        with common.full_f32():
            loss.backward()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif not _in_loss_net(name):
                    p.grad.mul_(0.0)
        optimizer.step()
        state.step += 1
        return state, {'loss': loss.detach()}

    return step


def train_loss_net(state, model, labelled_loader, cfg, logger, generator):
    """llal's LossNet fitting phase before a round's query: a fresh
    optimizer over ``LOSS_NET_TRAIN_EPOCH`` epochs of the labelled loader.
    Returns the state (its model updated in place)."""
    epochs = int(cfg.MODEL.ROI_HEAD.get('LOSS_NET_TRAIN_EPOCH', 1))
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, max(len(labelled_loader), 1) * epochs,
                                   model.parameters())
    step = make_lossnet_train_step(model, optimizer, labelled_loader.dataset)
    device = model.device
    for e in range(epochs):
        losses = [step(state, train_rt.host_to_device_batch(batch, device), generator)[1]['loss']
                  for batch in labelled_loader]
        logger.info('[llal] loss-net epoch %d loss %.4f', e,
                    float(torch.stack(losses).mean()) if losses else float('nan'))
    return state


def check_finite(model, where):
    """Raise unless every parameter and buffer (BN statistics) is finite."""
    bad = [k for k, v in model.state_dict().items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        raise RuntimeError(f'non-finite weights after {where}: {bad[:5]} '
                           f'({len(bad)} tensors)')


def train_model_active(cfg, args, batch_size, logger, output_dir, ckpt_dir,
                       workers=4, rank=0, tb_log=None, device='cuda'):
    """The AL outer loop (parity: train_active_utils.train_model_active) on
    ``device``.  Returns the final train state."""
    device = resolve_device(device)
    active_cfg = cfg.ACTIVE_TRAIN
    output_dir = Path(output_dir)
    active_label_dir = output_dir / 'active_labels'
    backbone_dir = output_dir / 'backbone'
    active_label_dir.mkdir(parents=True, exist_ok=True)
    backbone_dir.mkdir(parents=True, exist_ok=True)

    (labelled_set, _, labelled_loader, unlabelled_loader, _, _) = \
        build_active_dataloader(
            cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, False,
            workers=workers, logger=logger, training=True,
            pre_train_sample_nums=active_cfg.PRE_TRAIN_SAMPLE_NUMS, seed=666)

    # the JAX model's own init, drawn from a seeded generator
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), labelled_set,
                           device='cpu')
    flax_init(model, torch.Generator().manual_seed(INIT_SEED))
    model = model.to(device)

    pretrain_epochs = int(active_cfg.PRE_TRAIN_EPOCH_NUMS)
    interval = int(active_cfg.SELECT_LABEL_EPOCH_INTERVAL)
    num_rounds = int(active_cfg.TOTAL_BUDGET_NUMS) // int(active_cfg.SELECT_NUMS)
    logger.info('AL schedule: pretrain %d epochs, %d rounds x %d epochs '
                '(select %d/round, budget %d)', pretrain_epochs, num_rounds,
                interval, active_cfg.SELECT_NUMS, active_cfg.TOTAL_BUDGET_NUMS)

    generator = torch.Generator(device=device).manual_seed(DROPOUT_SEED)

    def new_state(loader, epochs):
        optimizer, _ = build_optimizer(cfg.OPTIMIZATION,
                                       max(len(loader), 1) * epochs,
                                       model.parameters())
        return (train_rt.init_train_state(model, optimizer),
                train_rt.make_train_step(model, optimizer, loader.dataset))

    def train_epochs(state, step, loader, first_epoch, n, tag):
        for epoch in range(first_epoch, first_epoch + n):
            state, loss = train_rt.train_one_epoch(
                state, step, loader, device, generator, logger=logger,
                cur_epoch=epoch, tb_log=tb_log)
            logger.info('[%s] epoch %d loss %.4f', tag, epoch, loss)
            if tb_log is not None:
                tb_log.add_scalar('train/epoch_loss', loss, epoch)
        check_finite(model, tag)
        return state

    state, train_step = new_state(labelled_loader, pretrain_epochs)

    # the init weights: every round retrains from them (parity:
    # train_active_utils.py:97-105,320-322)
    init_ckpt_path = backbone_dir / 'init_checkpoint'
    if not (backbone_dir / 'init_checkpoint.pth').exists():
        ckpt_rt.save_checkpoint(
            ckpt_rt.checkpoint_state(state, epoch=0, it=0), str(init_ckpt_path))
    init_ckpt = ckpt_rt.load_checkpoint(str(init_ckpt_path) + '.pth')

    # ---------------- PHASE A: pretrain -------------------------------------
    pretrain_ckpt, resumed_epoch = (None, 0)
    if active_cfg.get('TRAIN_RESUME', False):
        pretrain_ckpt, resumed_epoch = ckpt_rt.find_latest_checkpoint(backbone_dir)
    if pretrain_ckpt and resumed_epoch >= pretrain_epochs:
        state = ckpt_rt.restore_train_state(
            state, ckpt_rt.load_checkpoint(pretrain_ckpt))
        logger.info('resumed pretrain from %s', pretrain_ckpt)
    else:
        state = train_epochs(state, train_step, labelled_loader, 0,
                             pretrain_epochs, 'pretrain')
        ckpt_rt.save_checkpoint(
            ckpt_rt.checkpoint_state(state, epoch=pretrain_epochs, it=state.step),
            str(backbone_dir / f'checkpoint_epoch_{pretrain_epochs}'))

    # ---------------- PHASE B: selection rounds -----------------------------
    cur_epoch = pretrain_epochs
    for round_idx in range(num_rounds):
        logger.info('=== selection round %d/%d (epoch %d) ===',
                    round_idx + 1, num_rounds, cur_epoch)
        # crash-resume: this round's final checkpoint and pickle exist →
        # replay its selection into the loaders and skip the retrain
        done_ckpt = Path(ckpt_dir) / f'checkpoint_epoch_{cur_epoch + interval}.pth'
        sel_pkl = active_label_dir / \
            f'selected_frames_epoch_{cur_epoch}_rank_{rank}.pkl'
        if active_cfg.get('TRAIN_RESUME', False) and done_ckpt.exists() \
                and sel_pkl.exists():
            with open(sel_pkl, 'rb') as f:
                selected = set(pickle.load(f)['frame_id'])
            labelled_loader, unlabelled_loader = _rebuild(
                cfg, labelled_loader, unlabelled_loader, selected, logger)
            state = ckpt_rt.restore_train_state(
                state, ckpt_rt.load_checkpoint(str(done_ckpt)))
            cur_epoch += interval
            logger.info('round %d already complete — resumed from %s',
                        round_idx + 1, done_ckpt)
            continue
        if (active_cfg.METHOD == 'llal'
                and cfg.MODEL.get('ROI_HEAD', {}).get('LOSS_NET', None)):
            # fit the LossNet before querying (train_active_utils.py:242-296)
            state = train_loss_net(state, model, labelled_loader, cfg, logger, generator)
            check_finite(model, f'the LossNet fitting of round {round_idx + 1}')
        labelled_loader, unlabelled_loader, selected = select_active_labels(
            model, labelled_loader, unlabelled_loader, rank, logger,
            method=active_cfg.METHOD, cur_epoch=cur_epoch,
            active_label_dir=active_label_dir, cfg=cfg, tb_log=tb_log)
        logger.info('selected %d frames; labelled pool now %d', len(selected),
                    len(labelled_loader.dataset))

        # reset to the init weights and BN statistics, with a fresh optimizer
        # on this round's schedule (count 0, no moments)
        state, train_step = new_state(labelled_loader, interval)
        state = ckpt_rt.restore_train_state(state, init_ckpt)
        state = train_epochs(state, train_step, labelled_loader, cur_epoch,
                             interval, f'round {round_idx + 1}')
        cur_epoch += interval
        ckpt_rt.save_checkpoint(
            ckpt_rt.checkpoint_state(state, epoch=cur_epoch, it=state.step),
            str(Path(ckpt_dir) / f'checkpoint_epoch_{cur_epoch}'))
    return state
