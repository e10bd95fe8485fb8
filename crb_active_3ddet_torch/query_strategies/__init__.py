"""Query-strategy factory. Port of
``crb_active_3ddet_tpu/query_strategies/__init__.py`` (reference
``pcdet/query_strategies/__init__.py:12-29``): the same names; the strategy
takes the model (an ``nn.Module`` that holds its weights) without the JAX
``variables``.  The strategies that need MC-dropout rounds, LossNet or
per-sample gradients come with ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

from .confidence_sampling import ConfidenceSampling
from .coreset_sampling import CoresetSampling
from .entropy_sampling import EntropySampling
from .random_sampling import RandomSampling

__factory = {
    'random': RandomSampling,
    'entropy': EntropySampling,
    'coreset': CoresetSampling,
    'confidence': ConfidenceSampling,
}
_LATER = ('badge', 'bald', 'crb', 'llal', 'montecarlo')


def names():
    return sorted(list(__factory) + list(_LATER))


def build_strategy(method, model, labelled_loader, unlabelled_loader, rank,
                   active_label_dir, cfg):
    """The strategy scores on ``model``'s device (CUDA unless the model was
    built on the CPU)."""
    if method in _LATER:
        raise NotImplementedError(f'query strategy {method!r} comes with '
                                  'ROADMAP Queue 1 item 12')
    if method not in __factory:
        raise KeyError('Unknown query strategy:', method)
    return __factory[method](model, labelled_loader, unlabelled_loader, rank,
                             active_label_dir, cfg)
