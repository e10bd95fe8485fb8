"""A diagonal Gaussian mixture in numpy: a copy of scikit-learn 1.9's
``GaussianMixture(n_components=n, random_state=0,
covariance_type='diag').fit(X)`` (``sklearn/mixture/_base.py
BaseMixture.fit_predict``, ``_gaussian_mixture.py``: the 'diag' branches of
``_estimate_gaussian_parameters``, ``_compute_precision_cholesky`` and
``_estimate_log_gaussian_prob``; ``sklearn/utils/_array_api.py
_logsumexp``), which CRB's ``CLUSTERING: gmm``
(``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:141-144``) runs for
its ``means_``.  The port does not import scikit-learn.

The defaults: ``init_params='kmeans'``, ``n_init=1``, ``tol=1e-3``,
``reg_covar=1e-6``, ``max_iter=100``.  The only random draws are the init's:
one ``np.random.RandomState(random_state)``, handed to ``KMeans(n_init=1)``
(``kmeans.py``), whose k-means++ seeding draws from it; its labels give
one-hot responsibilities.  Then EM: the E step's log responsibilities from
the weighted log densities and sklearn's own log-sum-exp, the M step's
weights, means and variances (``nk`` plus ten machine epsilons,
``reg_covar`` added), precisions' Cholesky factors ``1/√var`` (a variance
≤ 0 raises, as in sklearn), until the mean log likelihood changes by less
than ``tol``.  Every step keeps the data's dtype (float32 embeddings stay
float32).  A run that does not converge warns, as sklearn does.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

from .kmeans import ConvergenceWarning, KMeans, as_float_array


def _estimate_gaussian_parameters(X, resp, reg_covar):
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, None]
    avg_X2 = (resp.T @ (X * X)) / nk[:, None]
    covariances = avg_X2 - means ** 2 + reg_covar
    return nk, means, covariances


def _compute_precision_cholesky(covariances):
    if np.any(covariances <= 0.0):
        raise ValueError(
            'Fitting the mixture model failed because some components have '
            'ill-defined empirical covariance (for instance caused by singleton '
            'or collapsed samples). Try to decrease the number of components, '
            'increase reg_covar, or scale the input data.')
    return 1.0 / np.sqrt(covariances)


def _estimate_log_gaussian_prob(X, means, precisions_chol):
    n_features = X.shape[1]
    log_det = np.sum(np.log(precisions_chol), axis=1)
    precisions = precisions_chol ** 2
    log_prob = (np.sum(means ** 2 * precisions, axis=1)
                - 2.0 * (X @ (means * precisions).T)
                + (X ** 2 @ precisions.T))
    return -0.5 * (n_features * math.log(2 * math.pi) + log_prob) + log_det


def _logsumexp(array, axis):
    """sklearn's ``_logsumexp`` (a simplified ``scipy.special.logsumexp``)."""
    array_max = np.max(array, axis=axis, keepdims=True)
    index_max = array == array_max
    array = np.array(array, copy=True)
    array[index_max] = -np.inf
    m = np.sum(index_max.astype(array.dtype), axis=axis, keepdims=True, dtype=array.dtype)
    shift = np.where(np.isfinite(array_max), array_max, 0)
    exp = np.exp(array - shift)
    s = np.sum(exp, axis=axis, keepdims=True, dtype=exp.dtype)
    s = np.where(s == 0, s, s / m)
    out = np.log1p(s) + np.log(m) + array_max
    return np.squeeze(out, axis=axis)


class GaussianMixture:
    """``sklearn.mixture.GaussianMixture(covariance_type='diag')`` at its
    defaults: ``fit(X)`` sets ``weights_``, ``means_``, ``covariances_``,
    ``precisions_cholesky_``, ``converged_`` and ``n_iter_``."""

    def __init__(self, n_components, random_state=0, tol=1e-3, reg_covar=1e-6,
                 max_iter=100):
        self.n_components = int(n_components)
        self.random_state = random_state
        self.tol, self.reg_covar, self.max_iter = tol, reg_covar, int(max_iter)

    def _e_step(self, X):
        weighted = _estimate_log_gaussian_prob(X, self.means_, self.precisions_cholesky_) \
            + np.log(self.weights_)
        log_prob_norm = _logsumexp(weighted, axis=1)
        with np.errstate(under='ignore'):
            log_resp = weighted - log_prob_norm[:, None]
        return np.mean(log_prob_norm), log_resp

    def _m_step(self, X, resp):
        self.weights_, self.means_, self.covariances_ = _estimate_gaussian_parameters(
            X, resp, self.reg_covar)
        self.precisions_cholesky_ = _compute_precision_cholesky(self.covariances_)

    def fit(self, X):
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = as_float_array(X)
        n_samples = X.shape[0]
        if n_samples < 2:
            raise ValueError(f'Found array with {n_samples} sample(s) while a minimum '
                             'of 2 is required by GaussianMixture.')
        if n_samples < self.n_components:
            raise ValueError('Expected n_samples >= n_components but got n_components = '
                             f'{self.n_components}, n_samples = {n_samples}')
        rng = np.random.RandomState(self.random_state)
        label = KMeans(self.n_components, random_state=rng).fit(X).labels_
        resp = np.zeros((n_samples, self.n_components), dtype=X.dtype)
        resp[np.arange(n_samples), label] = 1
        self._m_step(X, resp)
        self.weights_ /= n_samples
        lower_bound = -np.inf
        self.converged_ = False
        for n_iter in range(1, self.max_iter + 1):
            prev_lower_bound = lower_bound
            log_prob_norm, log_resp = self._e_step(X)
            self._m_step(X, np.exp(log_resp))
            self.weights_ /= np.sum(self.weights_)
            lower_bound = log_prob_norm
            if abs(lower_bound - prev_lower_bound) < self.tol:
                self.converged_ = True
                break
        self.n_iter_ = n_iter
        if not self.converged_ and self.max_iter > 0:
            warnings.warn('Best performing initialization did not converge. Try '
                          'different init parameters, or increase max_iter, tol, or '
                          'check for degenerate data.', ConvergenceWarning, stacklevel=2)
        return self
