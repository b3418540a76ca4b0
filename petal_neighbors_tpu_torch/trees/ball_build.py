"""Ball-tree host builders (a copy of the JAX package's
``trees/ball_build.py``: NumPy only).

The reference builds recursively on the host: per node, centroid + radius,
max-spread column, then a quickselect median partition of the index slice
(ball_tree.rs:504-613).  Because the tree is a complete binary tree with
exact-midpoint splits, the *shape* is static (utils.tree_math); only the
``idx`` permutation, centroids and radii are data.

Two builders live here:

* ``build_host_vectorized`` — the production host build.  The recursion
  collapses into a **level-synchronous** loop: per level one
  ``np.add/minimum/maximum.reduceat`` segment-reduction pass computes every
  node's centroid/radius/spread at once, and one ``np.lexsort`` partitions
  every segment around its median simultaneously.  O(height) passes instead
  of O(n_nodes) recursive calls.
* ``build_reference_order`` — a pure-Python transliteration-by-semantics of
  the reference algorithm (Lomuto quickselect ``halve_node_indices``,
  ball_tree.rs:545-569; first-wins ``max_spread_column``, :577-613) that
  reproduces the reference's exact ``idx`` permutation including tie
  order.  Used for golden parity tests, for metrics the native C++
  builder (``petal_neighbors_tpu_torch.native``) has no kind for, and as
  its spec.

Both produce the same tree *geometry* (ranges/shape); they may place tied
coordinate values on different sides of a median, which never changes
query results (bounds are computed from actual members).

Sort-based vs quickselect medians: a full per-segment sort keeps every
level one fused ``lexsort``; the asymptotic loss
(log n factor) is irrelevant next to the memory-bandwidth win.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..distance import Cosine, Euclidean, Metric, Minkowski
from ..utils.tree_math import TreeShape

__all__ = ["BallTreeData", "build_host_vectorized", "build_reference_order"]


@dataclass
class BallTreeData:
    """Flat SoA ball-tree arrays (host/NumPy); shape metadata is static."""

    centroids: np.ndarray   # (n_nodes, d)
    radii: np.ndarray       # (n_nodes,)
    idx: np.ndarray         # (n,) permutation of point ids
    shape: TreeShape


# ---------------------------------------------------------------------------
# NumPy metric helpers (host builder must not round-trip through the device)
# ---------------------------------------------------------------------------

def _np_rowwise_dist(metric: Metric, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Distance between matched rows of x and y, NumPy-side."""
    if isinstance(metric, Euclidean):
        d = x - y
        return np.sqrt(np.einsum("ij,ij->i", d, d))
    if isinstance(metric, Cosine):
        dot = np.einsum("ij,ij->i", x, y)
        nx = np.sqrt(np.einsum("ij,ij->i", x, x))
        ny = np.sqrt(np.einsum("ij,ij->i", y, y))
        return 1.0 - dot / (nx * ny)
    if metric.name == "manhattan":
        return np.abs(x - y).sum(axis=1)
    if isinstance(metric, Minkowski):
        return (np.abs(x - y) ** metric.p).sum(axis=1) ** (1.0 / metric.p)
    if metric.name == "chebyshev":
        return np.abs(x - y).max(axis=1)
    if metric.name == "haversine":
        hav = (np.sin((y[:, 0] - x[:, 0]) / 2) ** 2
               + np.cos(x[:, 0]) * np.cos(y[:, 0])
               * np.sin((y[:, 1] - x[:, 1]) / 2) ** 2)
        return 2.0 * np.arcsin(np.sqrt(np.clip(hav, 0.0, 1.0)))
    # generic fallback: per-row pair call
    return np.array([float(metric.distance(x[i], y[i])) for i in range(len(x))])


def _np_pair_dist(metric: Metric, x: np.ndarray, y: np.ndarray) -> float:
    return float(_np_rowwise_dist(metric, x[None, :], y[None, :])[0])


# ---------------------------------------------------------------------------
# Level-synchronous vectorized host builder
# ---------------------------------------------------------------------------

def build_host_vectorized(points: np.ndarray, shape: TreeShape,
                          metric: Metric) -> BallTreeData:
    """Level-synchronous batched build (the vectorized redesign of
    ball_tree.rs:504-538, run on the host)."""
    points = np.asarray(points)
    n, dim = points.shape
    assert n == shape.n
    # Accumulate centroid sums in f64 regardless of input dtype (the
    # reference accumulates in A; widening only tightens the result and the
    # golden-parity fixtures are f64 where the two coincide).
    acc_dtype = np.float64
    out_dtype = points.dtype

    idx = np.arange(n, dtype=np.int64)
    centroids = np.zeros((shape.n_nodes, dim), dtype=out_dtype)
    radii = np.zeros(shape.n_nodes, dtype=out_dtype)

    for level in range(shape.height):
        lo = (1 << level) - 1
        hi = (1 << (level + 1)) - 1
        starts = shape.range_start[lo:hi]
        ends = shape.range_end[lo:hi]
        counts = (ends - starts).astype(acc_dtype)

        pp = points[idx]  # points in current permutation order

        # centroid: mean of members (ball_tree.rs:445-456)
        sums = np.add.reduceat(pp.astype(acc_dtype), starts, axis=0)
        cent = (sums / counts[:, None]).astype(out_dtype)
        centroids[lo:hi] = cent

        # radius: max metric-distance from centroid to members (:458-460).
        # The reference folds with FloatCore::max (IEEE maxNum) from zero,
        # so NaN distances are ignored and an all-NaN node gets radius 0 —
        # fmax + nan_to_num reproduces that exactly.
        cent_of_pos = np.repeat(cent, (ends - starts), axis=0)
        dist = _np_rowwise_dist(metric, cent_of_pos, pp)
        radii[lo:hi] = np.nan_to_num(np.fmax.reduceat(dist, starts), nan=0.0)

        if level == shape.height - 1:
            break  # leaves: no partition below

        # split column: max spread, first-wins ties (:577-613)
        mins = np.minimum.reduceat(pp, starts, axis=0)
        maxs = np.maximum.reduceat(pp, starts, axis=0)
        spread = maxs - mins
        # A NaN spread must never win the argmax (reference: partial_cmp ==
        # Greater is false for NaN, ball_tree.rs:605); numpy argmax would
        # pick NaN, so demote it.
        spread = np.where(np.isnan(spread), -np.inf, spread)
        col = np.argmax(spread, axis=1)

        # median partition of every segment at once: stable lexsort by
        # (segment, split-column value). NaN sorts last, matching
        # OrderedFloat's NaN-is-greatest (CHANGELOG.md:111-115).
        seg_of_pos = shape.node_of_pos[level]          # values in [lo, hi)
        key = pp[np.arange(n), col[seg_of_pos - lo]]
        order = np.lexsort((key, seg_of_pos))
        idx = idx[order]

    return BallTreeData(centroids=centroids, radii=radii,
                        idx=idx.astype(np.int64), shape=shape)


# ---------------------------------------------------------------------------
# Reference-exact-order builder (golden parity; spec for the C++ native one)
# ---------------------------------------------------------------------------

def _halve_node_indices(idx: np.ndarray, col: np.ndarray) -> None:
    """In-place median partition, exact semantics of ball_tree.rs:545-569.

    After return, ``idx[mid]`` holds the median of ``col[idx]``; left of it
    strictly less, right greater-or-equal — including the reference's
    Lomuto sweep order so tied elements land on identical sides.
    """
    first, last = 0, len(idx) - 1
    mid = len(idx) // 2
    while True:
        cur = first
        pivot = col[idx[last]]
        for i in range(first, last):
            if col[idx[i]] < pivot:
                idx[i], idx[cur] = idx[cur], idx[i]
                cur += 1
        idx[cur], idx[last] = idx[last], idx[cur]
        if cur == mid:
            return
        if cur < mid:
            first = cur + 1
        else:
            last = cur - 1


def _max_spread_column(points: np.ndarray, idx: np.ndarray) -> int:
    """Argmax-spread column, strictly-greater-wins (ball_tree.rs:577-613).

    NaN spreads never win (partial_cmp == Greater is False for NaN),
    matching the reference.
    """
    member = points[idx]
    spread = member.max(axis=0) - member.min(axis=0)
    best_col, best = 0, spread[0]
    for i, s in enumerate(spread[1:], start=1):
        if s > best:  # NaN > x is False, like partial_cmp != Greater
            best_col, best = i, s
    return best_col


def build_reference_order(points: np.ndarray, shape: TreeShape,
                          metric: Metric) -> BallTreeData:
    """Recursive build replicating the reference's exact idx permutation
    (ball_tree.rs:504-538). Host-side, O(n log n); use for parity tests
    and small indexes — ``build_host_vectorized`` is the fast path."""
    points = np.asarray(points)
    n, dim = points.shape
    idx = np.arange(n, dtype=np.int64)
    centroids = np.zeros((shape.n_nodes, dim), dtype=points.dtype)
    radii = np.zeros(shape.n_nodes, dtype=points.dtype)
    n_nodes = shape.n_nodes

    def init_node(node: int, s: int, e: int) -> None:
        members = points[idx[s:e]]
        cent = members.sum(axis=0) / (e - s)   # mean (ball_tree.rs:445-456)
        centroids[node] = cent
        d = _np_rowwise_dist(metric, np.broadcast_to(cent, members.shape), members)
        # IEEE-maxNum fold from zero (NaN ignored), ball_tree.rs:458-460
        d = d[~np.isnan(d)]
        radii[node] = d.max() if d.size else 0.0

    # iterative DFS to dodge Python recursion limits on deep trees
    stack = [(0, 0, n)]
    while stack:
        node, s, e = stack.pop()
        init_node(node, s, e)
        left = 2 * node + 1
        if left >= n_nodes:
            continue  # leaf (ball_tree.rs:523-527)
        col_idx = _max_spread_column(points, idx[s:e])
        seg = idx[s:e]
        _halve_node_indices(seg, points[:, col_idx])
        idx[s:e] = seg
        mid = (s + e) // 2
        stack.append((left + 1, mid, e))
        stack.append((left, s, mid))

    return BallTreeData(centroids=centroids, radii=radii, idx=idx, shape=shape)
