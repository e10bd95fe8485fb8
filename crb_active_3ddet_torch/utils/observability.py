"""Metrics sinks: TensorBoard and wandb, each when it can be imported.

Copy of ``crb_active_3ddet_tpu/utils/observability.py:21 MetricsLogger``
(reference: tensorboardX and wandb inline in
``tools/train_utils/train_active_utils.py:71-77``,
``pcdet/query_strategies/strategy.py:42-63``, ``tools/test.py:104-149``).
One ``MetricsLogger`` owns both sinks: the CLIs (``tools/``) and
``Strategy.update_dashboard`` take it as their ``add_scalar`` sink.
TensorBoard writes only when ``torch.utils.tensorboard`` imports (it needs
the ``tensorboard`` package); wandb only when the package imports and the
caller asks for it (``--wandb``; project from ``WANDB_PROJECT``).
"""

from __future__ import annotations

import os


class MetricsLogger:
    """``add_scalar``-style facade over TensorBoard and an optional wandb
    run; with neither importable it drops every scalar."""

    def __init__(self, log_dir=None, use_wandb=False, run_name=None, config=None):
        self._tb = None
        self._wandb_run = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=str(log_dir))
            except Exception:       # tensorboard not installed
                self._tb = None
        if use_wandb:
            try:
                import wandb
                project = os.environ.get('WANDB_PROJECT', 'crb_active_3ddet_torch')
                self._wandb_run = wandb.init(project=project, name=run_name,
                                             config=dict(config) if config else None,
                                             reinit=True)
            except Exception:       # wandb not installed, or no run
                self._wandb_run = None

    def add_scalar(self, key, value, step=None):
        if self._tb is not None:
            self._tb.add_scalar(key, float(value), step)
        if self._wandb_run is not None:
            self._wandb_run.log({key: float(value)}, step=step)

    def add_scalars(self, mapping, step=None, prefix=''):
        for k, v in mapping.items():
            try:
                self.add_scalar(f'{prefix}{k}', float(v), step)
            except (TypeError, ValueError):
                continue

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._wandb_run is not None:
            self._wandb_run.finish()
