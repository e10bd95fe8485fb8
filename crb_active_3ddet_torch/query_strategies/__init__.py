"""Query-strategy factory. Port of
``crb_active_3ddet_tpu/query_strategies/__init__.py`` (reference
``pcdet/query_strategies/__init__.py:12-29``): the same names; the strategy
takes the model (an ``nn.Module`` that holds its weights) without the JAX
``variables``.  BADGE and llal (LossNet) come with ROADMAP Queue 1 item 12b.
"""

from __future__ import annotations

from .bald_sampling import BALDSampling
from .confidence_sampling import ConfidenceSampling
from .coreset_sampling import CoresetSampling
from .crb_sampling import CRBSampling
from .entropy_sampling import EntropySampling
from .montecarlo_sampling import MonteCarloSampling
from .random_sampling import RandomSampling

__factory = {
    'random': RandomSampling,
    'entropy': EntropySampling,
    'bald': BALDSampling,
    'coreset': CoresetSampling,
    'montecarlo': MonteCarloSampling,
    'confidence': ConfidenceSampling,
    'crb': CRBSampling,
}
_LATER = ('badge', 'llal')


def names():
    return sorted(list(__factory) + list(_LATER))


def build_strategy(method, model, labelled_loader, unlabelled_loader, rank,
                   active_label_dir, cfg):
    """The strategy scores on ``model``'s device (CUDA unless the model was
    built on the CPU)."""
    if method in _LATER:
        raise NotImplementedError(f'query strategy {method!r} comes with '
                                  'ROADMAP Queue 1 item 12b')
    if method not in __factory:
        raise KeyError('Unknown query strategy:', method)
    return __factory[method](model, labelled_loader, unlabelled_loader, rank,
                             active_label_dir, cfg)
