"""Checkpoint save/load (torch). Port of
``crb_active_3ddet_tpu/runtime/checkpoint.py`` (reference
``tools/train_utils/train_utils.py`` checkpoint_state / save_checkpoint,
and the resume scan).

A checkpoint is a dict with the JAX package's keys: ``epoch``, ``it``,
``model_state`` (the parameters), ``batch_stats`` (the BatchNorm running
statistics and the model's other persistent buffers), ``optimizer_state``,
``step`` and ``version``, stored with ``torch.save`` as
``<name>.pth`` (``checkpoint_epoch_<N>.pth`` for the epoch checkpoints).
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path

import torch

VERSION = 'crb3d_torch+0.1.0'


def _host(t):
    return t.detach().cpu().clone()


def checkpoint_state(state=None, epoch=None, it=None):
    out = {'epoch': epoch, 'it': it, 'version': VERSION}
    if state is not None:
        params = dict(state.model.named_parameters())
        out['model_state'] = {k: _host(v) for k, v in params.items()}
        out['batch_stats'] = {k: _host(v) for k, v in state.model.state_dict().items()
                              if k not in params}
        out['optimizer_state'] = _to_host(state.optimizer.state_dict())
        out['step'] = int(state.step)
    return out


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return _host(tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(ckpt_state: dict, filename='checkpoint'):
    filename = f'{filename}.pth'
    torch.save(ckpt_state, filename)
    return filename


def load_checkpoint(filename):
    return torch.load(filename, map_location='cpu')


def restore_train_state(state, ckpt: dict):
    """Load a checkpoint's parameters, batch statistics, optimizer state and
    step into ``state`` (in place, onto its model's device); returns it."""
    state.model.load_state_dict({**ckpt['model_state'], **ckpt['batch_stats']})
    if ckpt.get('optimizer_state') is not None:
        state.optimizer.load_state_dict(ckpt['optimizer_state'])
    if 'step' in ckpt:
        state.step = int(ckpt['step'])
    return state


def find_latest_checkpoint(ckpt_dir):
    """Newest epoch checkpoint in a directory: (path, epoch), or (None, 0)."""
    ckpts = glob.glob(str(Path(ckpt_dir) / 'checkpoint_epoch_*.pth'))
    if not ckpts:
        return None, 0

    def epoch_of(p):
        m = re.search(r'checkpoint_epoch_(\d+)', os.path.basename(p))
        return int(m.group(1)) if m else -1
    latest = max(ckpts, key=epoch_of)
    return latest, epoch_of(latest)
