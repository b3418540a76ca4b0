"""scikit-learn-compatible adapter: ``NearestNeighbors`` over the port's
exact indexes (the JAX package's ``sklearn.py``).

``fit`` / ``kneighbors`` / ``kneighbors_graph`` / ``radius_neighbors`` /
``radius_neighbors_graph``, with sklearn's semantics where they differ
from the reference crate's:

* ``kneighbors(X=None)`` leaves each training point out of its own list;
  with ``X`` given nothing is left out;
* ``radius_neighbors`` keeps the uniform inclusive ``d <= r`` (sklearn's,
  and the reference's documented contract, ball_tree.rs:123-124) through
  the flat streamed passes (``radius_counts_streaming``, one
  ``radius_capped`` pass sized by the largest count, ``distances_at``),
  not the ball tree's boundary rules, and makes nothing (n_queries,
  n)-shaped;
* an ``n_neighbors`` out of contract raises sklearn's errors where the
  indexes would clamp k to n; ``mode`` strings are checked.

The fitted index lives on ``device`` (None means ``"cuda"``); the radius
passes run on its resident copy there.  Results come back as NumPy, ids
int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import DIRECT_DIM_MAX, Minkowski, get_metric
from .ops import bruteforce as bf
from .trees import BallTree, BruteForce, VantagePointTree
from .utils.validation import check_query_batch

__all__ = ["NearestNeighbors"]

_ALGOS = ("auto", "ball_tree", "vp_tree", "brute")


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class NearestNeighbors:
    """Exact nearest-neighbour search in the shape of
    ``sklearn.neighbors.NearestNeighbors``.

    ``n_neighbors`` (default k), ``radius`` (default r), ``algorithm``
    ("auto" takes ``BruteForce`` above ``DIRECT_DIM_MAX`` dimensions,
    where trees cannot prune and the flat kernels serve, and the ball tree
    at or below), ``leaf_size`` (the ball tree's; None keeps its default),
    ``metric`` (a registered name or a ``Metric``; "minkowski" honours
    ``p``) and ``device`` (where the index lives; None means ``"cuda"``).
    """

    def __init__(self, *, n_neighbors: int = 5, radius: float = 1.0,
                 algorithm: str = "auto", leaf_size: int | None = None,
                 metric="euclidean", p: float = 2.0, device=None):
        if algorithm not in _ALGOS:
            raise ValueError(f"algorithm must be one of {_ALGOS}")
        self.n_neighbors = int(n_neighbors)
        self.radius = float(radius)
        self.algorithm = algorithm
        self.leaf_size = leaf_size
        self.metric = metric
        self.p = p
        self.device = device
        self._index = None

    # -- estimator surface ---------------------------------------------------
    def fit(self, X, y=None):
        """Build the index over ``X`` (n_samples, n_features), NumPy or a
        tensor."""
        metric = self.metric
        if isinstance(metric, str):
            if metric == "minkowski":
                metric = Minkowski(self.p) if self.p != 2.0 else "euclidean"
            metric = get_metric(metric)
        if not torch.is_tensor(X):
            X = np.asarray(X)
        algo = self.algorithm
        if algo == "auto":
            algo = "brute" if X.shape[1] > DIRECT_DIM_MAX else "ball_tree"
        if algo == "ball_tree":
            kw = {} if self.leaf_size is None else {
                "leaf_size": self.leaf_size}
            self._index = BallTree(X, metric, device=self.device, **kw)
        elif algo == "vp_tree":
            self._index = VantagePointTree(X, metric, device=self.device)
        else:
            self._index = BruteForce(X, metric, device=self.device)
        return self

    @property
    def n_samples_fit_(self) -> int:
        self._check_fitted()
        return int(self._index.points.shape[0])

    def _check_fitted(self):
        if self._index is None:
            raise ValueError("This NearestNeighbors instance is not "
                             "fitted yet; call fit(X) first")

    def _queries(self, X):
        """The query batch on the index's device; the fitted points for a
        self-query."""
        idx = self._index
        dtype = (idx._dtype() if isinstance(idx, BruteForce)
                 else idx.points.dtype)
        return check_query_batch(idx.points if X is None else X, idx.dim,
                                 dtype, idx.device)

    # -- k-NN ------------------------------------------------------------------
    def kneighbors(self, X=None, n_neighbors: int | None = None,
                   return_distance: bool = True):
        """(distances, indices) of the k nearest training points,
        ascending, (n_queries, k).  ``X=None`` queries the training set
        with each point left out of its own list.

        Raises sklearn's ``ValueError`` for k <= 0 and for k (+1 for a
        self-query) above ``n_samples_fit_``."""
        self._check_fitted()
        k = self.n_neighbors if n_neighbors is None else int(n_neighbors)
        if k <= 0:
            raise ValueError(f"Expected n_neighbors > 0. Got {k}")
        self_query = X is None
        kq = k + 1 if self_query else k
        n_fit = self.n_samples_fit_
        qs = self._queries(X)
        if kq > n_fit:
            raise ValueError(
                f"Expected n_neighbors <= n_samples_fit, but "
                f"n_neighbors = {kq}, n_samples_fit = {n_fit}, "
                f"n_samples = {qs.shape[0]}")
        d, i = self._index.query_batch(qs, kq)
        d, i = _host(d), _host(i)
        if self_query:
            # drop each row's own id; where a duplicate point crowded it
            # out, drop the first column
            rows = np.arange(len(i))
            own = i == rows[:, None]
            first = np.where(own.any(axis=1), own.argmax(axis=1), 0)
            keep = np.ones_like(i, dtype=bool)
            keep[rows, first] = False
            i = i[keep].reshape(len(rows), kq - 1)
            d = d[keep].reshape(len(rows), kq - 1)
        if return_distance:
            return d, i.astype(np.int64)
        return i.astype(np.int64)

    @staticmethod
    def _check_mode(mode: str) -> None:
        if mode not in ("connectivity", "distance"):
            raise ValueError(
                f'Unsupported mode, must be one of "connectivity" or '
                f'"distance" but got "{mode}" instead')

    def kneighbors_graph(self, X=None, n_neighbors: int | None = None,
                         mode: str = "connectivity"):
        """Sparse CSR (n_queries, n_samples_fit): ones or distances."""
        from scipy.sparse import csr_matrix

        self._check_mode(mode)
        d, i = self.kneighbors(X, n_neighbors, return_distance=True)
        nq, k = i.shape
        data = np.ones(nq * k) if mode == "connectivity" else d.ravel()
        indptr = np.arange(0, nq * k + 1, k)
        return csr_matrix((data, i.ravel(), indptr),
                          shape=(nq, self.n_samples_fit_))

    # -- radius ----------------------------------------------------------------
    def radius_neighbors(self, X=None, radius: float | None = None,
                         return_distance: bool = True):
        """Per-query ids (and distances) within ``radius`` (inclusive
        ``d <= r``), as object arrays of variable-length rows, the sklearn
        return shape.  A streamed count pass sizes one streamed capped
        pass, and distances are gathered per id list, all on the index's
        resident copy."""
        self._check_fitted()
        r = float(radius if radius is not None else self.radius)
        self_query = X is None
        idx = self._index
        qs = self._queries(X)
        if isinstance(idx, BruteForce):
            pts, qs, invalid = idx._radius_args(qs)
        else:
            pts, invalid = idx.points, None
        counts = bf.radius_counts_streaming(pts, qs, r, idx.metric,
                                            inclusive=True, invalid=invalid)
        nq = qs.shape[0]
        cap = int(counts.max()) if nq else 0
        ids_out = np.empty(nq, dtype=object)
        d_out = np.empty(nq, dtype=object)
        if cap == 0:
            for row in range(nq):
                ids_out[row] = np.empty(0, dtype=np.int64)
                d_out[row] = np.empty(0, dtype=np.float64)
            return (d_out, ids_out) if return_distance else ids_out
        ids, _ = bf.radius_capped(pts, qs, r, idx.metric, cap=cap,
                                  inclusive=True, invalid=invalid)
        if return_distance:
            d_cap = _host(bf.distances_at(pts, qs, ids, idx.metric))
        ids = _host(ids)
        for row in range(nq):
            sel = ids[row] >= 0
            if self_query:
                sel &= ids[row] != row
            ids_out[row] = ids[row, sel].astype(np.int64)
            if return_distance:
                d_out[row] = d_cap[row, sel].astype(np.float64)
        if return_distance:
            return d_out, ids_out
        return ids_out

    def radius_neighbors_graph(self, X=None, radius: float | None = None,
                               mode: str = "connectivity"):
        """Sparse CSR r-adjacency (the graph DBSCAN consumes)."""
        from scipy.sparse import csr_matrix

        self._check_mode(mode)
        d, ids = self.radius_neighbors(X, radius, return_distance=True)
        nq = len(ids)
        indptr = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum([len(x) for x in ids], out=indptr[1:])
        indices = (np.concatenate(ids) if indptr[-1]
                   else np.empty(0, dtype=np.int64))
        if mode == "connectivity":
            data = np.ones(indptr[-1])
        else:
            data = np.concatenate(d) if indptr[-1] else np.empty(0)
        return csr_matrix((data, indices, indptr),
                          shape=(nq, self.n_samples_fit_))
