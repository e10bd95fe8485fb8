"""What the CLIs share: config loading with ``--set`` overrides, the output
tree, the device rule and the profiler hook."""

from __future__ import annotations

from pathlib import Path

import torch

from ..config import cfg_from_list, load_config

REPO_ROOT = Path(__file__).resolve().parents[2]


def add_common_args(parser):
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--workers', type=int, default=0)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--wandb', action='store_true', default=False,
                        help='also log to wandb (WANDB_PROJECT env)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default; raises without a card) or 'cpu'")
    parser.add_argument('--output_dir', type=str, default=None,
                        help='default output/<cfg group>/<cfg name>/<extra_tag> '
                             'under the repo')


def load_cfg(args):
    cfg = load_config(args.cfg_file)
    if getattr(args, 'set_cfgs', None):
        cfg_from_list(args.set_cfgs, cfg)
    return cfg


def output_dir(args, cfg):
    if args.output_dir is not None:
        return Path(args.output_dir)
    return REPO_ROOT / 'output' / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag


def load_port_checkpoint(model, path):
    """A port checkpoint's parameters and buffers into ``model``; returns
    the checkpoint."""
    from ..runtime import checkpoint as ckpt_rt
    ck = ckpt_rt.load_checkpoint(path)
    model.load_state_dict({**ck['model_state'], **ck['batch_stats']})
    return ck


class Profiled:
    """``fn`` whose first ``n`` calls run under ``torch.profiler`` (CPU and,
    on a card, CUDA activity); after them the trace goes to
    ``out_dir/trace.json`` and the busiest ops to ``out_dir/summary.txt``.
    The JAX CLIs' ``--profile`` hook."""

    def __init__(self, fn, n, out_dir, device):
        self.fn, self.n, self.out_dir, self.device = fn, int(n), Path(out_dir), device
        self.calls = 0
        self.prof = None

    def __call__(self, *args, **kwargs):
        if self.calls == 0 and self.n > 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        out = self.fn(*args, **kwargs)
        self.calls += 1
        if self.prof is not None and self.calls == self.n:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            self.prof.__exit__(None, None, None)
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.out_dir / 'trace.json'))
            (self.out_dir / 'summary.txt').write_text(
                self.prof.key_averages().table(sort_by='self_cpu_time_total', row_limit=30))
            self.prof = None
        return out
