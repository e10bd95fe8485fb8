"""Coreset (k-center greedy). Copy of ``crb_active_3ddet_tpu/query_strategies/
coreset_sampling.py`` (reference ``pcdet/query_strategies/coreset_sampling.py``:
furthest-first on model embeddings of the unlabelled vs the labelled pool,
:31-50; pairwise distances :13-29).

The embeddings are the mean-pooled BEV features (signal ``embeddings``; no
NMS).  The labelled pass runs over the labelled loader as it is, wrap-padded
final batch included, so a padded frame counts twice in the mean distance,
as in the JAX package."""

from __future__ import annotations

import numpy as np

from ..runtime.train import host_to_device_batch
from .strategy import Strategy


def pairwise_squared_distances(x, y):
    x = x.reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    x_norm = (x ** 2).sum(1)[:, None]
    y_norm = (y ** 2).sum(1)[None, :]
    dist = x_norm + y_norm - 2.0 * x @ y.T
    dist = np.nan_to_num(dist, nan=0.0)
    return np.clip(dist, 0.0, None)


def furthest_first(X, X_set, n):
    """Greedy k-center (seed distance = the MEAN distance to the labelled
    set, like the reference)."""
    dist_ctr = pairwise_squared_distances(X, X_set)
    min_dist = dist_ctr.mean(axis=1)
    idxs = []
    for i in range(n):
        idx = int(np.argmax(min_dist))
        idxs.append(idx)
        if i < n - 1:
            dist_new = pairwise_squared_distances(X, X[idx:idx + 1])
            min_dist = np.minimum(min_dist, dist_new[:, 0])
    return idxs


class CoresetSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        unlabeled = self.scan_pool(signals=('embeddings',))
        unlabeled_ids = list(unlabeled.keys())
        unlabeled_emb = np.stack([unlabeled[f]['embeddings']
                                  for f in unlabeled_ids])
        # labelled pool pass (no bookkeeping overwrite)
        score = self._score_fns[(False, 0, frozenset(('embeddings',)))]
        labeled_emb = np.concatenate([
            score(host_to_device_batch(batch, self.model.device))['embeddings']
            .cpu().numpy() for batch in self.labelled_loader], axis=0)
        idxs = furthest_first(unlabeled_emb, labeled_emb,
                              n=self.cfg.ACTIVE_TRAIN.SELECT_NUMS)
        return [unlabeled_ids[i] for i in idxs]
