"""Query-strategy factory. Port of
``crb_active_3ddet_tpu/query_strategies/__init__.py`` (reference
``pcdet/query_strategies/__init__.py:12-29``): the same names; the strategy
takes the model (an ``nn.Module`` that holds its weights) without the JAX
``variables``.
"""

from __future__ import annotations

from .badge_sampling import BadgeSampling
from .bald_sampling import BALDSampling
from .confidence_sampling import ConfidenceSampling
from .coreset_sampling import CoresetSampling
from .crb_sampling import CRBSampling
from .entropy_sampling import EntropySampling
from .llal_sampling import LLALSampling
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
    'badge': BadgeSampling,
    'llal': LLALSampling,
}


def names():
    return sorted(__factory)


def build_strategy(method, model, labelled_loader, unlabelled_loader, rank,
                   active_label_dir, cfg):
    """The strategy scores on ``model``'s device (CUDA unless the model was
    built on the CPU)."""
    if method not in __factory:
        raise KeyError('Unknown query strategy:', method)
    return __factory[method](model, labelled_loader, unlabelled_loader, rank,
                             active_label_dir, cfg)
