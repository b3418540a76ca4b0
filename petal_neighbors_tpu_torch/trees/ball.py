"""BallTree, the central index (the JAX package's ``trees/ball.py``;
parity: ball_tree.rs:15-374).

Flat SoA layout on the device: ``centroids (n_nodes, d)``, ``radii
(n_nodes,)``, the ``idx`` permutation, and the points reordered by
``idx`` so that every node's members are one contiguous row range (the
reference's layout, ball_tree.rs:15-24).  Node ranges and leaf flags are
static host metadata (``TreeShape``).

The reference's API: ``new`` / ``euclidean`` with the Empty and
NotContiguous checks, ``query_nearest``, ``query`` (k=0 -> empty, k>n ->
n results, ascending), ``query_radius`` (inclusive subtree take, strict
leaf filter), and the node accessors petal-clustering uses
(``node_distance_lower_bound``, ``children_of``, ``points_of``,
``radius_of``, ``compare_nodes``, ``num_nodes``, ``num_points``;
ball_tree.rs:303-353).  Beyond it: the batched ``query_batch`` and
``query_radius_batch``, a ``leaf_size`` (batched leaf scans want 128-256,
not the reference's 1-2), and a choice of builders.

``device=None`` means ``"cuda"`` and raises without a card; pass
``device="cpu"`` to run on the CPU.  ``query_tree`` is the dual-tree join
(``trees/dual.py``); ``save`` writes the ``utils.serialize`` format.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..distance import DIRECT_DIM_MAX, Euclidean, Metric, get_metric
from ..ops.bruteforce import _pick_chunk, center_of
from ..utils.tree_math import TreeShape, tree_shape
from ..utils.validation import (check_points, check_query, check_query_batch,
                                resolve_device)
from . import ball_build, ball_query
from ._auto import use_device_build
from .ball_build import BallTreeData

__all__ = ["BallTree", "Node", "NodeTable"]


class Node:
    """View of one tree node (the reference's ``Node`` fields,
    ball_tree.rs:427-432: range, centroid, radius, is_leaf)."""

    __slots__ = ("range", "centroid", "radius", "is_leaf")

    def __init__(self, range_, centroid, radius, is_leaf):
        self.range = range_
        self.centroid = centroid
        self.radius = radius
        self.is_leaf = is_leaf

    def __repr__(self):
        return (f"Node(range={self.range}, radius={self.radius:.6g}, "
                f"is_leaf={self.is_leaf})")


class NodeTable:
    """SoA node arrays with reference-style access to one node."""

    def __init__(self, centroids, radii, shape: TreeShape):
        self.centroids = centroids          # (n_nodes, d) tensor
        self.radii = radii                  # (n_nodes,)
        self.shape = shape

    def __len__(self):
        return self.shape.n_nodes

    def __getitem__(self, i: int) -> Node:
        if not 0 <= i < len(self):
            raise IndexError(i)
        return Node(
            range_=range(int(self.shape.range_start[i]),
                         int(self.shape.range_end[i])),
            centroid=self.centroids[i].cpu().numpy(),
            radius=float(self.radii[i]),
            is_leaf=bool(self.shape.is_leaf[i]),
        )


class BallTree:
    """Exact metric ball-tree index over a dense points matrix."""

    def __init__(self, points, metric: Metric | str = "euclidean", *,
                 leaf_size: int | None = 128, builder: str = "auto",
                 device=None):
        """Build the tree (the reference's ``BallTree::new``,
        ball_tree.rs:38-63).

        Args:
          points: (n, d) float matrix (NumPy or a tensor).  Raises
            ``EmptyArrayError`` / ``NotContiguousError`` as the reference.
          metric: a ``Metric`` or a registry name; it must satisfy the
            triangle inequality.
          leaf_size: most points per leaf.  ``None`` is the reference's
            sizing (1-2 points per leaf, ball_tree.rs:51-52); results are
            the same at any size, the speed differs.
          builder: ``"auto"`` (the device build for a CUDA index of at
            least ``_auto.DEVICE_BUILD_MIN_N`` points, else
            ``"vectorized"``), ``"vectorized"`` (the level-synchronous
            host build), ``"device"`` (the same algorithm on the index's
            device) or ``"reference"`` (the reference's exact idx
            permutation with its quickselect tie order, ball_tree.rs:
            545-569: the native C++ builder, or the Python one for a
            metric the native builder has no kind for).
          device: where the index lives and queries run; None means
            ``"cuda"``.
        """
        self.metric = get_metric(metric)
        if not self.metric.tree_compatible:
            raise ValueError(
                f"metric {self.metric.name!r} violates the triangle "
                "inequality, so ball-tree pruning bounds are invalid; "
                "use BruteForce for this metric")
        self.device = resolve_device(device)
        self.points = check_points(points, self.device)
        n = self.points.shape[0]
        self.metric.validate_dim(self.points.shape[1])
        self._leaf_size = leaf_size
        self._shape = tree_shape(n, leaf_size)

        if builder == "auto":
            builder = ("device" if use_device_build(n, self.device)
                       else "vectorized")
        if builder == "device":
            from .ball_build_device import build_device
            data = build_device(self.points, self._shape, self.metric)
        elif builder in ("vectorized", "reference"):
            host = self.points.cpu().numpy()
            if builder == "vectorized":
                data = ball_build.build_host_vectorized(host, self._shape,
                                                        self.metric)
            elif native.native_kind(self.metric) is not None:
                c, r, idx = native.ball_build(host, self._shape.n_nodes,
                                              self.metric)
                data = BallTreeData(centroids=c, radii=r, idx=idx,
                                    shape=self._shape)
            else:
                data = ball_build.build_reference_order(host, self._shape,
                                                        self.metric)
        else:
            raise ValueError(f"unknown builder {builder!r}")
        #: the builder that made the tree ("device", "vectorized" or
        #: "reference"); "auto" resolved
        self.builder = builder
        self._init_from_data(data)

    def _init_from_data(self, data: BallTreeData, center=None) -> None:
        dev = self.device

        def on_device(a):
            return (a if torch.is_tensor(a)
                    else torch.from_numpy(np.ascontiguousarray(a))).to(dev)

        self.idx = np.asarray(data.idx, dtype=np.int64)      # public field
        self.nodes = NodeTable(on_device(data.centroids),
                               on_device(data.radii), data.shape)
        self._centroids = self.nodes.centroids
        self._radii = self.nodes.radii
        idx = torch.from_numpy(self.idx).to(dev)
        self._points_perm = self.points[idx]
        self._orig_ids = idx.to(torch.int32)
        self._pos_of_id = torch.empty_like(idx)
        self._pos_of_id[idx] = torch.arange(len(self.idx), device=dev)
        if isinstance(self.metric, Euclidean):
            # the product-form computations run on centred values for
            # exactness (ops.bruteforce.center_of); the norms match that
            self._qcenter = (center_of(self.points) if center is None
                             else torch.from_numpy(
                                 np.array(center, self._np_dtype())).to(dev))
            centered = self._points_perm - self._qcenter
            self._perm_norms = torch.sum(centered * centered, dim=-1)
        else:
            self._qcenter = None
            self._perm_norms = None
        lo = self._shape.leaf_offset
        self._leaf_centroids = self._centroids[lo:]
        self._leaf_radii = self._radii[lo:]

    @classmethod
    def euclidean(cls, points, **kwargs) -> "BallTree":
        """Convenience constructor (ball_tree.rs:356-374)."""
        return cls(points, Euclidean(), **kwargs)

    @classmethod
    def _from_arrays(cls, points, metric, leaf_size, centroids, radii, idx,
                     *, center=None, device=None):
        """A tree from its arrays (points, centroids, radii, idx), with no
        rebuild; ``center`` (Euclidean) is the centre its product-form
        bounds subtract, ``center_of(points)`` when None."""
        self = cls.__new__(cls)
        self.metric = get_metric(metric)
        self.device = resolve_device(device)
        self.points = check_points(points, self.device)
        self._leaf_size = leaf_size
        self._shape = tree_shape(self.points.shape[0], leaf_size)
        n_nodes, d = self._shape.n_nodes, self.points.shape[1]
        centroids, radii = np.asarray(centroids), np.asarray(radii)
        idx = np.asarray(idx)
        if (centroids.shape != (n_nodes, d) or radii.shape != (n_nodes,)
                or idx.shape != (self._shape.n,)):
            raise ValueError(
                f"arrays do not match {self._shape.n} points at leaf_size="
                f"{leaf_size}: centroids {centroids.shape}, radii "
                f"{radii.shape}, idx {idx.shape}")
        self.builder = None
        self._init_from_data(BallTreeData(
            centroids=centroids.astype(self._np_dtype()),
            radii=radii.astype(self._np_dtype()), idx=idx, shape=self._shape),
            center=center)
        return self

    def save(self, path) -> None:
        """Checkpoint the index to an ``.npz`` (``utils.serialize``)."""
        from ..utils.serialize import save_index
        save_index(self, path)

    def _dtype(self) -> torch.dtype:
        return self.points.dtype

    def _np_dtype(self):
        return np.float64 if self.points.dtype == torch.float64 \
            else np.float32

    # ------------------------------------------------------------------
    # single-query API (reference-shaped; ball_tree.rs:80-142)
    # ------------------------------------------------------------------
    def query_nearest(self, point):
        """(index, distance) of the nearest point (ball_tree.rs:80-87)."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        d, i = self._knn(q[None, :], 1)
        return int(i[0, 0]), float(d[0, 0])

    def query(self, point, k: int):
        """k nearest as numpy (indices, distances), ascending
        (ball_tree.rs:102-121); k=0 gives empty arrays, k>n gives n."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        k_eff = min(int(k), self.n)
        if k_eff == 0:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=self._np_dtype()))
        d, i = self._knn(q[None, :], k_eff)
        return i[0].cpu().numpy().astype(np.int64), d[0].cpu().numpy()

    def query_radius(self, point, distance):
        """All indices within ``distance`` as numpy int64, ascending
        (ball_tree.rs:123-142).  The reference's boundary rules: points
        of a node wholly inside are taken inclusively (``ub <= r``) with
        no distance test; scanned points need the strict ``d < r``
        (ball_tree.rs:271-277)."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        mask = self._radius_mask(q[None, :], distance)
        return np.flatnonzero(mask[0].cpu().numpy()).astype(np.int64)

    # ------------------------------------------------------------------
    # batched API
    # ------------------------------------------------------------------
    def query_batch(self, queries, k: int, *, chunk_leaves: int = 4,
                    with_stats: bool = False, scheme: str = "auto"):
        """Exact batched k-NN: (distances, ids) tensors, each (Q, min(k,
        n)), ascending.

        ``scheme``: "auto" takes the tile-shared frontier
        (``ball_query.knn_query_tiled``) for Euclidean at d <= 32, k <= 16
        and at least 512 queries, else the per-query best-first scan;
        "per_query" and "tiled" force one.  ``with_stats=True`` returns a
        third value, a dict of the scan's counts (``loop_chunks``: the
        loop's steps, each one device-to-host read)."""
        qs = check_query_batch(queries, self.dim, self._dtype(), self.device)
        k_eff = min(int(k), self.n)
        if k_eff == 0:
            empty = (torch.zeros((qs.shape[0], 0), dtype=self._dtype(),
                                 device=self.device),
                     torch.zeros((qs.shape[0], 0), dtype=torch.int32,
                                 device=self.device))
            return (*empty, {}) if with_stats else empty
        if scheme not in ("auto", "per_query", "tiled"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if scheme == "auto":
            scheme = ("tiled" if (self.dim <= DIRECT_DIM_MAX and k_eff <= 16
                                  and qs.shape[0] >= 512
                                  and isinstance(self.metric, Euclidean))
                      else "per_query")
        if scheme == "tiled":
            return ball_query.knn_query_tiled(
                self._points_perm, self._orig_ids, self._leaf_centroids,
                self._leaf_radii, qs, self._qcenter,
                k=k_eff, shape=self._shape, metric=self.metric,
                chunk_leaves=chunk_leaves, with_stats=with_stats)
        return self._knn(qs, k_eff, chunk_leaves=chunk_leaves,
                         with_stats=with_stats)

    def query_nearest_batch(self, queries):
        d, i = self.query_batch(queries, 1)
        return i[:, 0], d[:, 0]

    def query_radius_batch(self, queries, distance, *, cap: int | None = None,
                           scheme: str = "auto"):
        """Batched radius search: a (Q, n) bool mask in original id order,
        or with ``cap`` (ids (Q, cap) int32, counts (Q,) int32), ids in
        traversal order and -1 padded, counts exact past the cap.

        The capped form gathers only the leaves each query's traversal
        reaches.  ``scheme`` (capped form only): "auto" takes the
        tile-shared frontier for Euclidean at d <= 32 and at least 512
        queries, else the per-query scan; "per_query" and "tiled" force
        one."""
        qs = check_query_batch(queries, self.dim, self._dtype(), self.device)
        if cap is None:
            return self._radius_mask(qs, distance)
        if scheme not in ("auto", "per_query", "tiled"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if scheme == "auto":
            scheme = ("tiled" if (self.dim <= DIRECT_DIM_MAX
                                  and qs.shape[0] >= 512
                                  and isinstance(self.metric, Euclidean))
                      else "per_query")
        run = (ball_query.radius_query_capped_tiled if scheme == "tiled"
               else ball_query.radius_query_capped)
        return run(self._points_perm, self._orig_ids, self._centroids,
                   self._radii, qs, distance, shape=self._shape,
                   metric=self.metric, cap=cap,
                   point_chunk=self._chunk(qs))

    def query_radius_count_batch(self, queries, distance):
        """Per-query counts only (the DBSCAN core-point test): the capped
        per-query scan at cap 1, whose counts are exact."""
        qs = check_query_batch(queries, self.dim, self._dtype(), self.device)
        _, counts = ball_query.radius_query_capped(
            self._points_perm, self._orig_ids, self._centroids, self._radii,
            qs, distance, shape=self._shape, metric=self.metric, cap=1,
            point_chunk=self._chunk(qs))
        return counts

    def _chunk(self, qs) -> int:
        # the radius paths use the direct difference form at every dim
        return _pick_chunk(self.n, qs.shape[0], self.dim, None, direct=True)

    def _knn(self, qs, k_eff: int, chunk_leaves: int = 4,
             with_stats: bool = False):
        return ball_query.knn_query(
            self._points_perm, self._perm_norms, self._orig_ids,
            self._leaf_centroids, self._leaf_radii, qs, self._qcenter,
            k=k_eff, shape=self._shape, metric=self.metric,
            chunk_leaves=chunk_leaves, with_stats=with_stats)

    def _radius_mask(self, qs, distance):
        return ball_query.radius_query_mask(
            self._points_perm, self._pos_of_id, self._centroids, self._radii,
            qs, distance, shape=self._shape, metric=self.metric,
            point_chunk=self._chunk(qs))

    # ------------------------------------------------------------------
    # node accessors (petal-clustering; ball_tree.rs:303-353)
    # ------------------------------------------------------------------
    def node_distance_lower_bound(self, n1: int, n2: int) -> float:
        """max(d(c1, c2) - r1 - r2, 0) (ball_tree.rs:303-317)."""
        nn = self._shape.n_nodes
        if not (0 <= n1 < nn and 0 <= n2 < nn):
            raise IndexError("node index out of range")
        d = float(self.metric.rowwise_dist(self._centroids[n1][None, :],
                                           self._centroids[n2][None, :])[0])
        lb = d - float(self._radii[n1]) - float(self._radii[n2])
        return max(lb, 0.0)

    def children_of(self, n: int):
        """(left, right) ids, or None for a leaf (ball_tree.rs:320-328)."""
        if self._shape.is_leaf[n]:
            return None
        return 2 * n + 1, 2 * n + 2

    def points_of(self, n: int) -> np.ndarray:
        """Original point ids owned by node ``n`` (ball_tree.rs:331-333)."""
        s, e = self._shape.range_start[n], self._shape.range_end[n]
        return self.idx[s:e]

    def radius_of(self, n: int) -> float:
        return float(self._radii[n])

    def compare_nodes(self, x: int, y: int):
        """Order of the node radii: -1/0/+1, or None where incomparable
        (NaN; ball_tree.rs:341-343, partial_cmp)."""
        rx, ry = float(self._radii[x]), float(self._radii[y])
        if np.isnan(rx) or np.isnan(ry):
            return None
        return (rx > ry) - (rx < ry)

    def num_nodes(self) -> int:
        return self._shape.n_nodes

    def query_tree(self, other: "BallTree", k: int):
        """Dual-tree k-NN join: for every point of ``self``, the ``k``
        nearest points of ``other`` (``trees.dual.dual_tree_knn``);
        ``self.query_tree(self, k)`` is the all-k-NN self-join (HDBSCAN
        core distances)."""
        from .dual import dual_tree_knn
        return dual_tree_knn(self, other, k)

    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def shape(self) -> TreeShape:
        return self._shape
