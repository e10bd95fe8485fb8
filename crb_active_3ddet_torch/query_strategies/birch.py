"""BIRCH's CF tree in numpy: a copy of scikit-learn 1.9's
``Birch(n_clusters=n).fit(X).subcluster_centers_``
(``sklearn/cluster/_birch.py``: ``_CFSubcluster``, ``_CFNode``,
``_split_node``, ``Birch._fit``), which CRB's ``CLUSTERING: birch``
(``crb_active_3ddet_tpu/query_strategies/crb_sampling.py:139-140``) reads.
The port does not import scikit-learn.  BIRCH draws nothing at random.

The defaults: ``threshold=0.5``, ``branching_factor=50``.  Each row enters
the tree in order; at each node it goes to the closest subcluster
(``|c|² − 2·c·x``, first minimum), merges into a leaf subcluster when the
merged radius² stays ≤ threshold², else starts one; a node past the
branching factor splits around its two farthest subclusters (sklearn's
``euclidean_distances``: float32 rows upcast in chunks, ``kmeans_pp.py``,
the diagonal 0), and a split root grows the tree.  ``subcluster_centers_``
are the leaves' centroids in the leaves' linked order.  sklearn's final
step, an ``AgglomerativeClustering`` of those centroids into ``n_clusters``,
gives labels that CRB does not read and is not copied; its warning when
the tree holds fewer subclusters than ``n_clusters`` is.  The result is not
capped: there can be more subclusters than ``n_clusters``.  The arithmetic
keeps the data's dtype as sklearn's does (NumPy 2's scalar rules).
"""

from __future__ import annotations

import warnings

import numpy as np

from .kmeans import ConvergenceWarning, as_float_array
from .kmeans_pp import _row_norms_sq, _sq_distances_upcast


def _self_sq_distances(X):
    """``euclidean_distances(X, squared=True)``: (n, n), clipped at 0, the
    diagonal 0."""
    if X.dtype == np.float32:
        dist = _sq_distances_upcast(X, X)
    else:
        xx = _row_norms_sq(X)[:, None]
        dist = -2 * (X @ X.T)
        dist += xx
        dist += xx.T
    np.maximum(dist, 0, out=dist)
    np.fill_diagonal(dist, 0)
    return dist


def _split_node(node, threshold, branching_factor):
    """Two new subclusters, each holding a new node, that share the node's
    subclusters by their distance to its two farthest ones."""
    new_subcluster1, new_subcluster2 = _CFSubcluster(), _CFSubcluster()
    kw = dict(threshold=threshold, branching_factor=branching_factor,
              is_leaf=node.is_leaf, n_features=node.n_features,
              dtype=node.init_centroids_.dtype)
    new_node1, new_node2 = _CFNode(**kw), _CFNode(**kw)
    new_subcluster1.child_ = new_node1
    new_subcluster2.child_ = new_node2
    if node.is_leaf:
        if node.prev_leaf_ is not None:
            node.prev_leaf_.next_leaf_ = new_node1
        new_node1.prev_leaf_ = node.prev_leaf_
        new_node1.next_leaf_ = new_node2
        new_node2.prev_leaf_ = new_node1
        new_node2.next_leaf_ = node.next_leaf_
        if node.next_leaf_ is not None:
            node.next_leaf_.prev_leaf_ = new_node2
    dist = _self_sq_distances(node.centroids_)
    n_clusters = dist.shape[0]
    farthest_idx = np.unravel_index(dist.argmax(), (n_clusters, n_clusters))
    node1_dist, node2_dist = dist[(farthest_idx,)]
    node1_closer = node1_dist < node2_dist
    node1_closer[farthest_idx[0]] = True
    for idx, subcluster in enumerate(node.subclusters_):
        if node1_closer[idx]:
            new_node1.append_subcluster(subcluster)
            new_subcluster1.update(subcluster)
        else:
            new_node2.append_subcluster(subcluster)
            new_subcluster2.update(subcluster)
    return new_subcluster1, new_subcluster2


class _CFNode:
    """A node of the CF tree: at most ``branching_factor`` subclusters, their
    centroids and squared norms kept in preallocated rows."""

    def __init__(self, *, threshold, branching_factor, is_leaf, n_features, dtype):
        self.threshold = threshold
        self.branching_factor = branching_factor
        self.is_leaf = is_leaf
        self.n_features = n_features
        self.subclusters_ = []
        self.init_centroids_ = np.zeros((branching_factor + 1, n_features), dtype=dtype)
        self.init_sq_norm_ = np.zeros((branching_factor + 1), dtype)
        self.squared_norm_ = []
        self.prev_leaf_ = None
        self.next_leaf_ = None

    def append_subcluster(self, subcluster):
        n_samples = len(self.subclusters_)
        self.subclusters_.append(subcluster)
        self.init_centroids_[n_samples] = subcluster.centroid_
        self.init_sq_norm_[n_samples] = subcluster.sq_norm_
        self.centroids_ = self.init_centroids_[: n_samples + 1, :]
        self.squared_norm_ = self.init_sq_norm_[: n_samples + 1]

    def update_split_subclusters(self, subcluster, new_subcluster1, new_subcluster2):
        ind = self.subclusters_.index(subcluster)
        self.subclusters_[ind] = new_subcluster1
        self.init_centroids_[ind] = new_subcluster1.centroid_
        self.init_sq_norm_[ind] = new_subcluster1.sq_norm_
        self.append_subcluster(new_subcluster2)

    def insert_cf_subcluster(self, subcluster):
        """Insert below this node; True when this node must split."""
        if not self.subclusters_:
            self.append_subcluster(subcluster)
            return False
        dist_matrix = np.dot(self.centroids_, subcluster.centroid_)
        dist_matrix *= -2.0
        dist_matrix += self.squared_norm_
        closest_index = np.argmin(dist_matrix)
        closest_subcluster = self.subclusters_[closest_index]
        if closest_subcluster.child_ is not None:
            split_child = closest_subcluster.child_.insert_cf_subcluster(subcluster)
            if not split_child:
                closest_subcluster.update(subcluster)
                self.init_centroids_[closest_index] = closest_subcluster.centroid_
                self.init_sq_norm_[closest_index] = closest_subcluster.sq_norm_
                return False
            new_subcluster1, new_subcluster2 = _split_node(
                closest_subcluster.child_, self.threshold, self.branching_factor)
            self.update_split_subclusters(closest_subcluster, new_subcluster1,
                                          new_subcluster2)
            return len(self.subclusters_) > self.branching_factor
        if closest_subcluster.merge_subcluster(subcluster, self.threshold):
            self.init_centroids_[closest_index] = closest_subcluster.centroid_
            self.init_sq_norm_[closest_index] = closest_subcluster.sq_norm_
            return False
        split = len(self.subclusters_) >= self.branching_factor
        self.append_subcluster(subcluster)
        return split


class _CFSubcluster:
    """A subcluster: count, linear sum, summed squared norms, centroid and
    its squared norm, and the child node below it (None in a leaf)."""

    def __init__(self, *, linear_sum=None):
        if linear_sum is None:
            self.n_samples_ = 0
            self.squared_sum_ = 0.0
            self.centroid_ = self.linear_sum_ = 0
        else:
            self.n_samples_ = 1
            self.centroid_ = self.linear_sum_ = linear_sum
            self.squared_sum_ = self.sq_norm_ = np.dot(self.linear_sum_, self.linear_sum_)
        self.child_ = None

    def update(self, subcluster):
        self.n_samples_ += subcluster.n_samples_
        self.linear_sum_ += subcluster.linear_sum_
        self.squared_sum_ += subcluster.squared_sum_
        self.centroid_ = self.linear_sum_ / self.n_samples_
        self.sq_norm_ = np.dot(self.centroid_, self.centroid_)

    def merge_subcluster(self, nominee_cluster, threshold):
        """Merge the nominee if the merged radius² is ≤ threshold²."""
        new_ss = self.squared_sum_ + nominee_cluster.squared_sum_
        new_ls = self.linear_sum_ + nominee_cluster.linear_sum_
        new_n = self.n_samples_ + nominee_cluster.n_samples_
        new_centroid = (1 / new_n) * new_ls
        new_sq_norm = np.dot(new_centroid, new_centroid)
        sq_radius = new_ss / new_n - new_sq_norm
        if sq_radius <= threshold ** 2:
            (self.n_samples_, self.linear_sum_, self.squared_sum_, self.centroid_,
             self.sq_norm_) = (new_n, new_ls, new_ss, new_centroid, new_sq_norm)
            return True
        return False


class Birch:
    """``sklearn.cluster.Birch``'s CF tree: ``fit(X)`` sets
    ``subcluster_centers_`` (the leaves' centroids in linked order)."""

    def __init__(self, n_clusters=3, threshold=0.5, branching_factor=50):
        self.n_clusters = n_clusters
        self.threshold = threshold
        self.branching_factor = branching_factor

    def fit(self, X):
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = as_float_array(X)
        n_features = X.shape[1]
        kw = dict(threshold=self.threshold, branching_factor=self.branching_factor,
                  n_features=n_features, dtype=X.dtype)
        self.root_ = _CFNode(is_leaf=True, **kw)
        self.dummy_leaf_ = _CFNode(is_leaf=True, **kw)
        self.dummy_leaf_.next_leaf_ = self.root_
        self.root_.prev_leaf_ = self.dummy_leaf_
        for sample in iter(X):
            subcluster = _CFSubcluster(linear_sum=sample)
            if self.root_.insert_cf_subcluster(subcluster):
                new_subcluster1, new_subcluster2 = _split_node(
                    self.root_, self.threshold, self.branching_factor)
                self.root_ = _CFNode(is_leaf=False, **kw)
                self.root_.append_subcluster(new_subcluster1)
                self.root_.append_subcluster(new_subcluster2)
        self.subcluster_centers_ = np.concatenate(
            [leaf.centroids_ for leaf in self._get_leaves()])
        if len(self.subcluster_centers_) < self.n_clusters:
            warnings.warn(f'Number of subclusters found ({len(self.subcluster_centers_)}) '
                          f'by BIRCH is less than ({self.n_clusters}). Decrease the '
                          'threshold.', ConvergenceWarning, stacklevel=2)
        return self

    def _get_leaves(self):
        leaf_ptr = self.dummy_leaf_.next_leaf_
        leaves = []
        while leaf_ptr is not None:
            leaves.append(leaf_ptr)
            leaf_ptr = leaf_ptr.next_leaf_
        return leaves
