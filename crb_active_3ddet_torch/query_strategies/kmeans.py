"""k-means in numpy: a copy of scikit-learn 1.9's ``KMeans(n_clusters,
random_state=0).fit(X)`` (``sklearn/cluster/_kmeans.py KMeans.fit``,
``_kmeans_single_lloyd``; ``_k_means_lloyd.pyx lloyd_iter_chunked_dense``;
``_k_means_common.pyx`` ``_relocate_empty_clusters_dense``,
``_average_centers``, ``_center_shift``), which CRB's ``CLUSTERING: kmeans``
(``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:136``) and the
Gaussian mixture's init (``gaussian_mixture.py``) run.  The port does not
import scikit-learn.

The defaults as that call has them: ``n_init='auto'`` (one run, k-means++
init), ``algorithm='lloyd'``, ``max_iter=300``, ``tol=1e-4``, unit sample
weights.  In sklearn's order: the tolerance is ``tol`` times the mean of the
features' variances; X (a float32 or float64 copy) is centred on its mean;
the k-means++ seeds (``kmeans_pp.py``) are the only random draws, from one
``np.random.RandomState``; Lloyd's iterations run over chunks of 256 rows
(squared distances ``|c|² − 2·x·c``, the first minimum wins; the
centre sums over every row in order, as one thread adds them), relocate an empty cluster
to the point farthest from its centre, divide the sums by the counts
(``1.0 / count`` in double, cast to the data's type) and stop on labels
equal to the last iteration's or a summed squared centre shift ≤ the
tolerance, then relabel once more unless the labels converged; the mean is
added back.  Fewer distinct labels than clusters (duplicate points) warn,
as sklearn does, and do not fail.
"""

from __future__ import annotations

import warnings

import numpy as np

from .kmeans_pp import _row_norms_sq, kmeans_plusplus

CHUNK_SIZE = 256        # sklearn's _k_means_common.CHUNK_SIZE


class ConvergenceWarning(UserWarning):
    """sklearn.exceptions.ConvergenceWarning's counterpart."""


def as_float_array(X):
    """sklearn's ``validate_data(dtype=[float64, float32])``: a C-ordered
    copy, float32 kept, anything else float64."""
    X = np.asarray(X)
    dtype = X.dtype if X.dtype in (np.float32, np.float64) else np.float64
    return np.array(X, dtype=dtype, order='C', copy=True)


def _lloyd_iter(X, centers_old, centers_new, weight, labels, center_shift,
                update_centers=True):
    """``lloyd_iter_chunked_dense`` with unit weights: labels in place and,
    with ``update_centers``, the new centres, counts and centre shifts."""
    n, k = X.shape[0], centers_old.shape[0]
    c_sq = _row_norms_sq(centers_old)
    for start in range(0, n, CHUNK_SIZE):
        dist = X[start:start + CHUNK_SIZE] @ centers_old.T
        dist *= -2
        dist += c_sq[None, :]
        labels[start:start + dist.shape[0]] = np.argmin(dist, axis=1)
    if update_centers:
        # one thread's sums: every row in order
        centers_new[...] = 0
        weight[...] = 0
        for i, label in enumerate(labels):
            weight[label] += 1
            centers_new[label] += X[i]
        _relocate_empty_clusters(X, centers_old, centers_new, weight, labels)
        _average_centers(centers_new, weight)
        for j in range(k):
            center_shift[j] = _euclidean(centers_old[j], centers_new[j])


def _relocate_empty_clusters(X, centers_old, centers_new, weight, labels):
    empty = np.where(np.equal(weight, 0))[0].astype(np.int32)
    n_empty = empty.shape[0]
    if n_empty == 0:
        return
    distances = ((X - centers_old[labels]) ** 2).sum(axis=1)
    far = np.argpartition(distances, -n_empty)[:-n_empty - 1:-1].astype(np.int32)
    if np.max(distances) == 0:
        return
    for new_id, far_idx in zip(empty, far):
        old_id = labels[far_idx]
        centers_new[old_id] -= X[far_idx]
        centers_new[new_id] = X[far_idx]
        weight[new_id] = 1
        weight[old_id] -= 1


def _average_centers(centers, weight):
    argmax_weight = np.argmax(weight)
    for j in range(centers.shape[0]):
        if weight[j] > 0:
            centers[j] *= centers.dtype.type(1.0 / float(weight[j]))
        else:
            centers[j] = centers[argmax_weight]


def _euclidean(a, b):
    """``_euclidean_dense_dense(squared=False)``: squares summed four at a
    time, the fours added in order, then the rest."""
    sq = (a - b) * (a - b)
    n4 = sq.shape[0] // 4
    fours = sq[:4 * n4].reshape(n4, 4)
    fours = ((fours[:, 0] + fours[:, 1]) + fours[:, 2]) + fours[:, 3]
    result = np.cumsum(fours)[-1] if n4 else sq.dtype.type(0)
    for v in sq[4 * n4:]:
        result = result + v
    return np.sqrt(result)


def _lloyd(X, centers_init, max_iter, tol):
    """``_kmeans_single_lloyd``: (labels, centres)."""
    centers = centers_init
    centers_new = np.zeros_like(centers)
    labels = np.full(X.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    weight = np.zeros(centers.shape[0], dtype=X.dtype)
    center_shift = np.zeros(centers.shape[0], dtype=X.dtype)
    strict_convergence = False
    for _ in range(max_iter):
        _lloyd_iter(X, centers, centers_new, weight, labels, center_shift)
        centers, centers_new = centers_new, centers
        if np.array_equal(labels, labels_old):
            strict_convergence = True
            break
        if (center_shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict_convergence:
        _lloyd_iter(X, centers, centers, weight, labels, center_shift,
                    update_centers=False)
    return labels, centers


class KMeans:
    """``sklearn.cluster.KMeans`` at its defaults (one k-means++ run of
    Lloyd's algorithm): ``fit(X)`` sets ``cluster_centers_`` and
    ``labels_``."""

    def __init__(self, n_clusters, random_state=0, max_iter=300, tol=1e-4):
        self.n_clusters = int(n_clusters)
        self.random_state = random_state
        self.max_iter = int(max_iter)
        self.tol = tol

    def fit(self, X):
        X = as_float_array(X)
        if X.shape[0] < self.n_clusters:
            raise ValueError(f'n_samples={X.shape[0]} should be >= '
                             f'n_clusters={self.n_clusters}.')
        tol = np.mean(np.var(X, axis=0)) * self.tol if self.tol else 0
        X_mean = X.mean(axis=0)
        X -= X_mean
        seeds = kmeans_plusplus(X, self.n_clusters, random_state=self.random_state)
        labels, centers = _lloyd(X, X[seeds], self.max_iter, tol)
        centers += X_mean
        distinct = len(set(labels.tolist()))
        if distinct < self.n_clusters:
            warnings.warn(f'Number of distinct clusters ({distinct}) found smaller than '
                          f'n_clusters ({self.n_clusters}). Possibly due to duplicate '
                          'points in X.', ConvergenceWarning, stacklevel=2)
        self.cluster_centers_ = centers
        self.labels_ = labels
        return self
