"""Optimizer and learning-rate schedule (torch). Port of
``crb_active_3ddet_tpu/runtime/optimization.py``, which builds
``optax.chain(clip_by_global_norm(GRAD_NORM_CLIP), adamw(schedule, wd))``
(or adam, or sgd) — reference ``tools/train_utils/optimization``.

The updates are ``torch.optim``'s AdamW, Adam and SGD over one parameter
group: AdamW decays every parameter, biases and BN affine terms included,
with the scheduled LR, as optax's ``adamw``; SGD adds the decay to the
gradient before its momentum, as ``add_decayed_weights`` before ``sgd``.
Two parts are written out with optax's arithmetic instead of torch's
helpers:
  * the clip leaves the gradients alone below the limit and scales them by
    limit / norm above it (``clip_grad_norm_`` divides by norm + 1e-6);
  * the one-cycle schedule is optax's ``cosine_onecycle_schedule`` formula
    (``OneCycleLR`` puts its phase boundary a step earlier and cycles the
    momentum; the JAX package ignores ``MOMS``), evaluated on the host and
    set as the group's LR before each update; the first update uses
    ``schedule(0)``.
"""

from __future__ import annotations

import numpy as np
import torch


def cosine_onecycle_schedule(transition_steps, peak_value, pct_start=0.3,
                             div_factor=25.0, final_div_factor=1e4):
    """optax's one-cycle schedule: cosine from peak/div up to peak at
    ``pct_start`` of the steps, then down to peak/(div·final_div); constant
    after.  On the host, with optax's arithmetic: the phase's position and
    the half-range in float64, the cosine and the interpolation in float32
    (JAX without x64)."""
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    sizes = bounds[1:] - bounds[:-1]
    end = values[1:].astype(np.float32)
    half = ((values[:-1] - values[1:]) / 2.0).astype(np.float32)

    def schedule(count):
        indicator = (bounds[:-1] <= count) & (count < bounds[1:])
        with np.errstate(divide='ignore', invalid='ignore'):
            pct = (count - bounds[:-1]) / sizes
        # the float32 angle's cosine, rounded once to float32 (as XLA's is)
        cos = np.cos((np.pi * pct).astype(np.float32).astype(np.float64)) \
            .astype(np.float32)
        interp = end + half * (cos + np.float32(1))
        return float(indicator.astype(np.float32).dot(interp)
                     + (bounds[-1] <= count) * values[-1])
    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """optax's piecewise constant schedule: each scale applies from its
    boundary step on."""
    def schedule(count):
        v = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                v *= scale
        return float(v)
    return schedule


def build_lr_schedule(optim_cfg, total_steps: int):
    """step → learning rate, as the JAX ``build_lr_schedule``."""
    name = optim_cfg.get('OPTIMIZER', 'adam_onecycle')
    lr = float(optim_cfg['LR'])
    if name == 'adam_onecycle':
        return cosine_onecycle_schedule(
            max(total_steps, 1), lr, float(optim_cfg.get('PCT_START', 0.4)),
            float(optim_cfg.get('DIV_FACTOR', 10)), 1e4)
    # adam / sgd: decay at the DECAY_STEP_LIST entries, taken as steps, as
    # the JAX package takes them
    decay = float(optim_cfg.get('LR_DECAY', 0.1))
    boundaries = {int(e): decay for e in optim_cfg.get('DECAY_STEP_LIST', [])}
    return piecewise_constant_schedule(lr, boundaries)


class Optimizer:
    """The optax chain over one ``torch.optim`` optimizer: optax's
    ``clip_by_global_norm`` on the gradients (in place), then ``inner``'s
    update at the LR that ``schedule`` gives for ``count``, the number of
    updates taken.  No host sync."""

    def __init__(self, inner, schedule, max_norm=0.0):
        self.inner, self.schedule, self.max_norm = inner, schedule, float(max_norm)
        self.count = 0

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        grads = [p.grad for g in self.inner.param_groups for p in g['params']
                 if p.grad is not None]
        if self.max_norm > 0 and grads:
            # untouched below max_norm, else scaled by max_norm / norm
            norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
            torch._foreach_mul_(grads, torch.where(norm < self.max_norm,
                                                   torch.ones_like(norm),
                                                   self.max_norm / norm))
        for group in self.inner.param_groups:
            group['lr'] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self):
        return {'count': self.count, 'inner': self.inner.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state['count'])
        self.inner.load_state_dict(state['inner'])


def build_optimizer(optim_cfg, total_steps: int, params):
    """Returns (Optimizer over ``params``, schedule), as the JAX
    ``build_optimizer`` returns (optax chain, schedule)."""
    schedule = build_lr_schedule(optim_cfg, total_steps)
    name = optim_cfg.get('OPTIMIZER', 'adam_onecycle')
    wd = float(optim_cfg.get('WEIGHT_DECAY', 0.0))
    lr = schedule(0)
    if name in ('adam', 'adam_onecycle'):
        inner = (torch.optim.AdamW(params, lr, eps=1e-8, weight_decay=wd) if wd > 0
                 else torch.optim.Adam(params, lr, eps=1e-8))
    elif name == 'sgd':
        inner = torch.optim.SGD(params, lr, momentum=float(optim_cfg.get('MOMENTUM', 0.9)),
                                weight_decay=wd)
    else:
        raise KeyError(f'unknown optimizer {name}')
    return Optimizer(inner, schedule, float(optim_cfg.get('GRAD_NORM_CLIP', 0.0))), schedule
