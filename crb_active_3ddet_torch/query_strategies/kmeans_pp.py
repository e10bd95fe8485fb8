"""k-means++ seeding in numpy: a copy of scikit-learn 1.9's
``sklearn/cluster/_kmeans.py _kmeans_plusplus`` as
``kmeans_plusplus(X, n_clusters, random_state=0)`` calls it, which CRB's
stage 2 (``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:133``) and
BADGE use.  The port does not import scikit-learn.

Unit sample weights; ``2 + int(log k)`` local trials a centre; one
``np.random.RandomState(seed)`` drawn in sklearn's order (``choice`` for the
first centre, then ``uniform`` for each later one); candidates by
``searchsorted`` over the cumulative potential, clipped into range; the
candidate that lowers the potential most wins (``argmin``, first on a tie).
Squared distances as sklearn's ``_euclidean_distances``: float32 rows are
upcast to float64 in sklearn's chunks, ``-2·x·y + |x|² + |y|²`` there, cast
back to float32 and clipped at 0; float64 rows directly, with the rows'
squared norms computed once.
"""

from __future__ import annotations

import math

import numpy as np


def _row_norms_sq(x):
    return np.einsum('ij,ij->i', x, x)


def _chunks(n, size):
    """sklearn's ``gen_batches(n, size)``."""
    for start in range(0, n, size):
        yield slice(start, min(start + size, n))


def _sq_distances_upcast(x, y):
    """float32 x (m, d), y (n, d) → (m, n) float32 squared distances,
    computed in float64 chunks as sklearn's ``_euclidean_distances_upcast``
    sizes them (about 10 % more memory than the operands, at least 10 MiB)."""
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    maxmem = max(((m + n) * d + m * n) / 10, 10 * 2 ** 17)
    tmp = 2 * d
    size = max(int((-tmp + math.sqrt(tmp ** 2 + 4 * maxmem)) / 2), 1)
    out = np.empty((m, n), dtype=np.float32)
    for xs in _chunks(m, size):
        xc = x[xs].astype(np.float64)
        xx = _row_norms_sq(xc)[:, None]
        for ys in _chunks(n, size):
            yc = y[ys].astype(np.float64)
            dist = -2 * (xc @ yc.T)
            dist += xx
            dist += _row_norms_sq(yc)[None, :]
            out[xs, ys] = dist.astype(np.float32, copy=False)
    return out


def _sq_distances(x, y, y_sq):
    """Squared distances of the rows of x to the rows of y, clipped at 0."""
    if x.dtype == np.float32:
        dist = _sq_distances_upcast(x, y)
    else:
        dist = -2 * (x @ y.T)
        dist += _row_norms_sq(x)[:, None]
        dist += y_sq[None, :]
    np.maximum(dist, 0, out=dist)
    return dist


def kmeans_plusplus(X, n_clusters, random_state=0):
    """Indices of ``n_clusters`` k-means++ seeds among the rows of X
    (float32 or float64)."""
    X = np.asarray(X)
    n_samples = X.shape[0]
    if n_samples < n_clusters:
        raise ValueError(f'n_samples={n_samples} should be >= n_clusters={n_clusters}.')
    rng = np.random.RandomState(random_state)
    weight = np.ones(n_samples, dtype=X.dtype)
    y_sq = _row_norms_sq(X) if X.dtype == np.float64 else None
    n_local_trials = 2 + int(np.log(n_clusters))

    center_id = rng.choice(n_samples, p=weight / weight.sum())
    indices = np.full(n_clusters, -1, dtype=int)
    indices[0] = center_id
    closest = _sq_distances(X[center_id][None], X, y_sq)
    current_pot = closest @ weight
    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        # rounding can put a candidate past the end
        np.clip(candidate_ids, None, closest.size - 1, out=candidate_ids)
        dist = _sq_distances(X[candidate_ids], X, y_sq)
        np.minimum(closest, dist, out=dist)
        candidates_pot = dist @ weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest = dist[best]
        indices[c] = candidate_ids[best]
    return indices
