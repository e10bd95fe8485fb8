"""The training-mode arithmetic of two Flax layers, applied to torch modules.

``flax_batch_norm`` is ``flax.linen.BatchNorm`` in training
(``use_fast_variance``): the batch statistics over every axis but the
channel axis, with no mask, the biased variance ``max(E[x²] − E[x]², 0)``
both normalising and entering the running variance, and the running
statistics updated as ``0.99·old + 0.01·new`` (torch's own update would enter
the unbiased variance).  ``FlaxBatchNorm2d`` (BEV backbone) and the point
branch's BatchNorms (``pfe.run_pointwise``) both train through it; the
sparse backbone's ``MaskedBatchNorm`` is another statistic.

``flax_dropout`` is ``flax.linen.Dropout``: keep with probability 1 − p,
scale the kept entries by 1/(1 − p), with the keep mask drawn from a
``torch.Generator`` that the caller passes (on the tensor's device), never
from torch's global RNG.
"""

from __future__ import annotations

import torch

KEEP = 0.99          # Flax's BatchNorm momentum: the running statistics' share


def flax_batch_norm(x, bn, channel_dim: int = -1):
    """Normalise ``x`` by its batch statistics over every axis but
    ``channel_dim`` with ``bn``'s eps, weight and bias, and update ``bn``'s
    running statistics in place, as Flax's training step does."""
    dim = channel_dim % x.ndim
    red = tuple(d for d in range(x.ndim) if d != dim)
    mean = x.mean(red)
    var = torch.clamp((x * x).mean(red) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(KEEP * bn.running_mean + (1 - KEEP) * mean)
        bn.running_var.copy_(KEEP * bn.running_var + (1 - KEEP) * var)
    shape = [1] * x.ndim
    shape[dim] = -1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.reshape(shape)) * mul.reshape(shape) + bn.bias.reshape(shape)


def flax_dropout(x, p: float, live: bool, generator):
    """Inverted dropout of rate ``p`` when ``live``; the identity otherwise
    or when p = 0.  A live draw without a generator raises."""
    if not live or p == 0:
        return x
    if generator is None:
        raise RuntimeError('a live Dropout draws its mask from a torch.Generator '
                           'that the caller passes; none was given')
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
