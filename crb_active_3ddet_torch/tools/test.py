"""Evaluation CLI of the port.

Counterpart of the JAX package's ``tools/test.py`` (reference
``tools/test.py``): evaluate one ``--ckpt``, or with ``--eval_all`` watch a
checkpoint directory (:95-154) and evaluate each new
``checkpoint_epoch_<N>.pth`` once, keeping a record file so that a restart
skips the finished epochs.  Every evaluation is ``runtime/eval.py``'s
``eval_one_epoch`` over the config's test split; the detections go to
``<output>/eval/result.pkl``.  The JAX flags are kept but the multi-host ones
(``--coordinator``, ``--num_processes``, ``--process_id``: ROADMAP Queue 1
item 15); ``--device`` (default ``cuda``; raises without a card) and
``--output_dir`` are added.

    python -m crb_active_3ddet_torch.tools.test --cfg_file <yaml> --ckpt <pth> [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import glob
import re
import time
from pathlib import Path

from ..datasets import build_dataloader
from ..models.detectors import build_detector
from ..runtime import eval as eval_rt
from ..utils import common as common_utils
from ..utils.observability import MetricsLogger
from . import common


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='evaluate port checkpoints')
    common.add_common_args(parser)
    parser.add_argument('--eval_all', action='store_true', default=False)
    parser.add_argument('--ckpt_dir', type=str, default=None)
    parser.add_argument('--max_waiting_mins', type=float, default=30)
    parser.add_argument('--profile', type=int, default=0,
                        help='trace the first N eval batches with torch.profiler '
                             'into <eval_dir>/profile')
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return args, common.load_cfg(args)


def eval_ckpt(ckpt_path, model, eval_step, test_set, test_loader, cfg, device,
              logger, result_dir):
    common.load_port_checkpoint(model, ckpt_path)
    ap_str, ap_dict, _ = eval_rt.eval_one_epoch(
        eval_step, test_set, test_loader, cfg.CLASS_NAMES, device=device,
        logger=logger, result_dir=result_dir)
    logger.info('\n%s', ap_str)
    logger.info('Result: %s', {k: round(float(v), 4) for k, v in ap_dict.items()})
    return ap_dict


def _epoch(path):
    return int(re.search(r'epoch_(\d+)', Path(path).name).group(1))


def main(argv=None):
    """Returns the AP dict of ``--ckpt``, or with ``--eval_all`` {epoch: AP
    dict} of the checkpoints evaluated."""
    args, cfg = parse_config(argv)
    device = common_utils.resolve_device(args.device)
    common_utils.set_random_seed(1024)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    output_dir = common.output_dir(args, cfg)
    eval_dir = output_dir / 'eval'
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = common_utils.create_logger(
        eval_dir / f'log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt', rank=0)
    logger.info('device: %s', device)
    tb_log = MetricsLogger(log_dir=eval_dir / 'tensorboard', use_wandb=args.wandb,
                           run_name=f'eval_{cfg.TAG}_{args.extra_tag}', config=cfg)

    test_set, test_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, workers=args.workers,
        logger=logger, training=False)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device=device)
    eval_step = eval_rt.make_eval_step(model, test_set, cfg.MODEL.POST_PROCESSING,
                                       num_class=len(cfg.CLASS_NAMES))
    if args.profile > 0:
        eval_step = common.Profiled(eval_step, args.profile, eval_dir / 'profile', device)
        logger.info('profiling the first %d eval batches -> %s', args.profile,
                    eval_dir / 'profile')

    if not args.eval_all:
        if args.ckpt is None:
            raise ValueError('--ckpt is required without --eval_all')
        ap = eval_ckpt(args.ckpt, model, eval_step, test_set, test_loader, cfg, device,
                       logger, eval_dir)
        tb_log.add_scalars(ap, step=0, prefix='eval/')
        tb_log.close()
        return ap

    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else output_dir / 'ckpt'
    record_file = eval_dir / 'eval_list_val.txt'
    evaluated = set(record_file.read_text().split()) if record_file.exists() else set()
    results = {}
    wait_start = time.time()
    while True:
        ckpts = sorted(glob.glob(str(ckpt_dir / 'checkpoint_epoch_*.pth')), key=_epoch)
        todo = [c for c in ckpts if c not in evaluated]
        if not todo:
            if time.time() - wait_start > args.max_waiting_mins * 60:
                break
            time.sleep(30)
            continue
        wait_start = time.time()
        for c in todo:
            epoch = _epoch(c)
            logger.info('==> evaluating %s', c)
            results[epoch] = eval_ckpt(c, model, eval_step, test_set, test_loader, cfg,
                                       device, logger, eval_dir / f'epoch_{epoch}')
            tb_log.add_scalars(results[epoch], step=epoch, prefix='eval/')
            tb_log.flush()
            evaluated.add(c)
            with open(record_file, 'a') as f:
                print(c, file=f)
    tb_log.close()
    return results


if __name__ == '__main__':
    main()
