"""Training CLI of the port.

Counterpart of the JAX package's ``tools/train.py`` (reference
``tools/train.py``: arguments :32-68, config merge, the active or standard
trainer :139-162,222-224, seed 666 :91, auto-resume :181-191).  With
``ACTIVE_TRAIN`` in the config it runs ``runtime/active.py
train_model_active``; else it trains the detector from the JAX model's own
initialisation (``flax_init``, seed 0), resuming from the newest
``checkpoint_epoch_<N>.pth`` of its output tree (or from ``--ckpt``), and
saves a checkpoint every ``--ckpt_save_interval`` epochs and at the last,
keeping at most ``--max_ckpt_save_num``.  ``SELF_TRAIN`` (ST3D), the
data-parallel ``--mesh`` and the multi-host flags wait for ROADMAP Queue 1
item 15.  ``--device`` (default ``cuda``; raises without a card) and
``--output_dir`` are added.

    python -m crb_active_3ddet_torch.tools.train --cfg_file <yaml> [--epochs N] [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os

import torch

from ..config import log_config_to_file
from ..datasets import build_dataloader
from ..models.detectors import build_detector, flax_init
from ..runtime import checkpoint as ckpt_rt
from ..runtime import train as train_rt
from ..runtime.optimization import build_optimizer
from ..utils import common as common_utils
from ..utils.observability import MetricsLogger
from . import common

INIT_SEED = 0           # the JAX init_train_state's PRNGKey(0)
SEED = 666              # the reference's seed; the JAX loop's PRNGKey(666)


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='train a detector with the port')
    common.add_common_args(parser)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--fix_random_seed', action='store_true', default=True)
    parser.add_argument('--ckpt_save_interval', type=int, default=1)
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--profile', type=int, default=0,
                        help='trace the first N train steps with torch.profiler '
                             'into <output>/profile')
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return args, common.load_cfg(args)


def _save(state, epoch, ckpt_dir, max_keep):
    """``checkpoint_epoch_<epoch>.pth``, the oldest removed first so that at
    most ``max_keep`` stay (reference ``train_utils.py:112-118``)."""
    old = sorted(glob.glob(str(ckpt_dir / 'checkpoint_epoch_*.pth')), key=os.path.getmtime)
    for path in old[:max(len(old) - max_keep + 1, 0)]:
        os.remove(path)
    return ckpt_rt.save_checkpoint(ckpt_rt.checkpoint_state(state, epoch=epoch, it=state.step),
                                   str(ckpt_dir / f'checkpoint_epoch_{epoch}'))


def main(argv=None):
    """Returns the final train state (the AL loop's with ``ACTIVE_TRAIN``)."""
    args, cfg = parse_config(argv)
    device = common_utils.resolve_device(args.device)
    if cfg.get('SELF_TRAIN', None):
        raise NotImplementedError('SELF_TRAIN (ST3D self-training) is not ported; it comes '
                                  'with ROADMAP Queue 1 item 15')
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    output_dir = common.output_dir(args, cfg)
    ckpt_dir = output_dir / 'ckpt'
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    logger = common_utils.create_logger(
        output_dir / f'log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt', rank=0)
    logger.info('**********************Start logging**********************')
    logger.info('device: %s', device)
    log_config_to_file(cfg, logger=logger)
    if args.fix_random_seed:
        common_utils.set_random_seed(SEED)
    tb_log = MetricsLogger(log_dir=output_dir / 'tensorboard', use_wandb=args.wandb,
                           run_name=f'{cfg.TAG}_{args.extra_tag}', config=cfg)

    if cfg.get('ACTIVE_TRAIN', None):
        from ..runtime.active import train_model_active
        state = train_model_active(cfg, args, batch_size, logger, output_dir, ckpt_dir,
                                   workers=args.workers, tb_log=tb_log, device=device)
        tb_log.close()
        logger.info('**********************End active training**********************')
        return state

    train_set, train_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, workers=args.workers,
        logger=logger, training=True, seed=SEED)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), train_set, device='cpu')
    flax_init(model, torch.Generator().manual_seed(INIT_SEED))
    model = model.to(device)
    steps_per_epoch = max(len(train_loader), 1)
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, steps_per_epoch * epochs,
                                   model.parameters())
    state = train_rt.init_train_state(model, optimizer)

    start_epoch = 0
    latest, last_epoch = ckpt_rt.find_latest_checkpoint(ckpt_dir)
    if args.ckpt is not None:
        state = ckpt_rt.restore_train_state(state, ckpt_rt.load_checkpoint(args.ckpt))
        logger.info('Restored from %s', args.ckpt)
    elif latest is not None:
        state = ckpt_rt.restore_train_state(state, ckpt_rt.load_checkpoint(latest))
        start_epoch = last_epoch
        logger.info('Auto-resumed from %s (epoch %d)', latest, last_epoch)

    train_step = train_rt.make_train_step(model, optimizer, train_set)
    if args.profile > 0:
        train_step = common.Profiled(train_step, args.profile, output_dir / 'profile', device)
        logger.info('profiling the first %d steps -> %s', args.profile, output_dir / 'profile')
    generator = torch.Generator(device=device).manual_seed(SEED)
    logger.info('*************** Start training (%d epochs, %d steps/epoch) ***************',
                epochs, steps_per_epoch)
    for epoch in range(start_epoch, epochs):
        state, loss = train_rt.train_one_epoch(
            state, train_step, train_loader, device, generator, logger=logger,
            tb_log=tb_log, cur_epoch=epoch)
        logger.info('epoch %d done: loss %.4f', epoch, loss)
        tb_log.add_scalar('train/epoch_loss', loss, epoch)
        if (epoch + 1) % args.ckpt_save_interval == 0 or epoch + 1 == epochs:
            logger.info('Saved %s', _save(state, epoch + 1, ckpt_dir, args.max_ckpt_save_num))
    tb_log.close()
    logger.info('**********************End training**********************')
    return state


if __name__ == '__main__':
    main()
