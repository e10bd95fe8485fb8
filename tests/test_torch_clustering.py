"""The port's numpy copies of CRB's scikit-learn prototype selectors
(``query_strategies/kmeans.py``, ``birch.py``, ``gaussian_mixture.py``)
against scikit-learn 1.9 itself, as the JAX package calls it
(``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:135-145``):
``KMeans(n, random_state=0)``, ``Birch(n_clusters=n)`` and
``GaussianMixture(n, random_state=0, covariance_type='diag')``.

Seeded float32 data at stage 2's widths (D = 576 and PV-RCNN's 65 536 at
``shared_fc_1``) with N = 8 and 20 rows: clustered (points within BIRCH's
0.5 radius of their centre, so subclusters merge) and spread (every row a
subcluster of its own, more than ``n_k2``).  Centres, means, weights and
variances rtol 1e-5; labels, the subclusters' count and order and
``scipy.cluster.vq.vq``'s picks equal.  A tree past BIRCH's branching factor
(120 rows) exercises the node splits; float64 data and many EM iterations
the dtype and the loop.  Degenerate: every row equal (KMeans warns of fewer
distinct clusters, BIRCH keeps one subcluster, the mixture's variances are
not positive and both raise).
"""

import warnings

import numpy as np
import pytest
from scipy.cluster.vq import vq

from crb_active_3ddet_torch.query_strategies import crb_sampling
from crb_active_3ddet_torch.query_strategies.birch import Birch
from crb_active_3ddet_torch.query_strategies.gaussian_mixture import GaussianMixture
from crb_active_3ddet_torch.query_strategies.kmeans import ConvergenceWarning, KMeans

sklearn = pytest.importorskip('sklearn')
from sklearn.cluster import Birch as SkBirch  # noqa: E402
from sklearn.cluster import KMeans as SkKMeans  # noqa: E402
from sklearn.mixture import GaussianMixture as SkGaussianMixture  # noqa: E402

TOL = dict(rtol=1e-5, atol=0)


def _data(seed, n, d, k, spread, dtype=np.float32):
    """n rows around k seeded centres, taken in turn (no centre without a
    row: k-means over fewer groups than clusters would split a group by
    rounding), each row ``spread`` from its centre in norm."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(k, d)
    return (centres[rng.permutation(np.arange(n) % k)]
            + rng.randn(n, d) * spread / np.sqrt(d)).astype(dtype)


def _ours_and_sklearn(X, k):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return {
            'kmeans': (KMeans(k, random_state=0).fit(X), SkKMeans(k, random_state=0).fit(X)),
            'birch': (Birch(n_clusters=k).fit(X), SkBirch(n_clusters=k).fit(X)),
            'gmm': (GaussianMixture(k, random_state=0).fit(X),
                    SkGaussianMixture(k, random_state=0, covariance_type='diag').fit(X)),
        }


CASES = [(d, n, spread) for d in (576, 65536) for n in (8, 20) for spread in (0.3, 30.0)]


@pytest.mark.parametrize('d, n, spread', CASES)
def test_clusterings_match_sklearn(d, n, spread):
    k = 3 if n == 8 else 4
    X = _data(n + d, n, d, k, spread)
    fits = _ours_and_sklearn(X, k)
    ours, sk = fits['kmeans']
    np.testing.assert_allclose(ours.cluster_centers_, sk.cluster_centers_, **TOL)
    np.testing.assert_array_equal(ours.labels_, sk.labels_)
    assert ours.cluster_centers_.dtype == sk.cluster_centers_.dtype == np.float32
    ours, sk = fits['birch']
    assert ours.subcluster_centers_.shape == sk.subcluster_centers_.shape
    np.testing.assert_allclose(ours.subcluster_centers_, sk.subcluster_centers_, **TOL)
    if spread > 1:      # every row apart: more subclusters than n_k2, in row order
        assert len(ours.subcluster_centers_) == n > k
        np.testing.assert_array_equal(ours.subcluster_centers_, X)
    ours, sk = fits['gmm']
    for attr in ('means_', 'weights_', 'covariances_', 'precisions_cholesky_'):
        np.testing.assert_allclose(getattr(ours, attr), getattr(sk, attr), **TOL, err_msg=attr)
        assert getattr(ours, attr).dtype == getattr(sk, attr).dtype == np.float32
    assert (ours.n_iter_, ours.converged_) == (sk.n_iter_, sk.converged_)
    for name, centres in (('kmeans', 'cluster_centers_'), ('birch', 'subcluster_centers_'),
                          ('gmm', 'means_')):
        ours, sk = fits[name]
        np.testing.assert_array_equal(vq(getattr(ours, centres), X)[0],
                                      vq(getattr(sk, centres), X)[0], err_msg=name)


@pytest.mark.parametrize('n, d, k, spread, dtype', [
    (120, 8, 5, 1.0, np.float32),        # past the branching factor: node splits
    (200, 4, 3, 2.0, np.float64),        # float64, EM over a dozen iterations
    (300, 3, 6, 3.0, np.float32)])
def test_tree_splits_and_em_iterations_match_sklearn(n, d, k, spread, dtype):
    X = _data(7, n, d, k, spread, dtype)
    fits = _ours_and_sklearn(X, k)
    ours, sk = fits['kmeans']
    np.testing.assert_allclose(ours.cluster_centers_, sk.cluster_centers_, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ours.labels_, sk.labels_)
    ours, sk = fits['birch']
    assert ours.subcluster_centers_.shape == sk.subcluster_centers_.shape
    np.testing.assert_allclose(ours.subcluster_centers_, sk.subcluster_centers_, **TOL)
    if n == 120:
        assert not ours.root_.is_leaf and len(ours._get_leaves()) >= 2
    ours, sk = fits['gmm']
    for attr in ('means_', 'weights_', 'covariances_'):
        np.testing.assert_allclose(getattr(ours, attr), getattr(sk, attr), rtol=1e-5, atol=1e-6,
                                   err_msg=attr)
        assert getattr(ours, attr).dtype == dtype
    assert ours.n_iter_ == sk.n_iter_
    assert n == 120 or ours.n_iter_ > 5


def test_every_row_equal():
    X = np.tile(np.random.RandomState(3).randn(1, 576).astype(np.float32), (8, 1))
    with pytest.warns(ConvergenceWarning, match='distinct clusters'):
        ours = KMeans(3, random_state=0).fit(X)
    with pytest.warns(sklearn.exceptions.ConvergenceWarning, match='distinct clusters'):
        sk = SkKMeans(3, random_state=0).fit(X)
    np.testing.assert_allclose(ours.cluster_centers_, sk.cluster_centers_, **TOL)
    np.testing.assert_array_equal(ours.labels_, sk.labels_)
    with pytest.warns(ConvergenceWarning, match='less than'):
        ours = Birch(n_clusters=3).fit(X)
    with pytest.warns(sklearn.exceptions.ConvergenceWarning, match='less than'):
        sk = SkBirch(n_clusters=3).fit(X)
    assert ours.subcluster_centers_.shape == sk.subcluster_centers_.shape == (1, 576)
    np.testing.assert_allclose(ours.subcluster_centers_, sk.subcluster_centers_, **TOL)
    for fit in (lambda: GaussianMixture(3, random_state=0).fit(X),
                lambda: SkGaussianMixture(3, random_state=0, covariance_type='diag').fit(X)):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            with pytest.raises(ValueError, match='ill-defined empirical covariance'):
                fit()


@pytest.mark.parametrize('clustering', crb_sampling.CLUSTERINGS)
def test_prototypes_dedup_and_backfill(clustering):
    """Stage 2's picks for each option: equal rows collapse to one pick and
    the stage-1 ranking backfills; BIRCH over spread rows keeps them all."""
    X = _data(5, 8, 576, 3, 30.0)
    X[4:] = X[0]
    ranked = [f'f{i}' for i in range(8)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        picks = crb_sampling.prototypes(clustering, X, 3)
    frames = crb_sampling.dedup_backfill([ranked[i] for i in picks], ranked, 3)
    assert len(set(frames)) == len(frames) >= 3
    if clustering == 'birch':
        assert len(frames) == 4          # three apart rows and the repeated one
    with pytest.raises(NotImplementedError):
        crb_sampling.prototypes('dbscan', X, 3)
