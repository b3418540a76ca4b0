"""DBSCAN on the port's batched radius search (``examples/dbscan.py``
on ``petal_neighbors_tpu_torch``).

The reference crate's primary consumer is petal-clustering's DBSCAN
(ball_tree.rs ``query_radius`` serves it).  Neighbour counts and the
capped neighbour lists come from ``BallTree.query_radius_count_batch`` and
``query_radius_batch`` in large batches on the index's device; the host
joins the core points' neighbourhoods into clusters with one connected-
components pass over the core-core pairs.

Run:  python examples/torch_dbscan.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NOISE = -1


def core_mask(points, eps: float, min_samples: int, *, batch: int = 4096,
              device=None, tree=None) -> np.ndarray:
    """DBSCAN's pass 1: which points have at least ``min_samples``
    neighbours within ``eps`` (themselves included), from neighbour counts
    on the device, batched (``tree``: the ``BallTree`` over ``points``,
    built on ``device`` when None)."""
    from petal_neighbors_tpu_torch import BallTree

    points = np.asarray(points)
    if tree is None:
        tree = BallTree.euclidean(points, device=device)
    counts = np.empty(points.shape[0], dtype=np.int64)
    for s in range(0, points.shape[0], batch):
        counts[s:s + batch] = tree.query_radius_count_batch(
            points[s:s + batch], eps).cpu().numpy()
    return counts >= min_samples


def dbscan(points, eps: float, min_samples: int, *, batch: int = 4096,
           cap: int = 1024, device=None):
    """Exact DBSCAN labels (NOISE = -1), the same labels as
    ``examples/dbscan.py``.

    Neighbourhoods follow the ``BallTree`` radius rules (the reference's
    exact behaviour, ball_tree.rs:271-277): a point at exactly ``eps`` is
    in when its whole leaf ball lies within ``eps`` (the inclusive subtree
    take), leaf-scanned points by the strict ``d < eps``.  A core point
    has at least ``min_samples`` neighbours (itself included); clusters
    are the connected components of core points within ``eps``; a border
    point joins the cluster of the lowest-id core point that lists it.
    Labels number clusters in order of their lowest member.  ``device``:
    where the tree lives (None means ``"cuda"``).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from petal_neighbors_tpu_torch import BallTree

    points = np.asarray(points)
    n = points.shape[0]
    tree = BallTree.euclidean(points, device=device)

    core = core_mask(points, eps, min_samples, batch=batch, tree=tree)

    # pass 2: each core point's neighbour list -> (core, member) pairs
    src, dst = [], []
    for s in range(0, n, batch):
        ids, cnts = tree.query_radius_batch(points[s:s + batch], eps,
                                            cap=cap)
        ids, cnts = ids.cpu().numpy(), cnts.cpu().numpy()
        if (cnts > cap).any():
            raise ValueError(
                f"neighbor cap {cap} exceeded (max {int(cnts.max())}); "
                "raise `cap`")
        rows = np.flatnonzero(core[s:s + len(ids)])
        listed = np.arange(ids.shape[1])[None, :] < cnts[rows, None]
        src.append(np.repeat(s + rows, listed.sum(1)))
        dst.append(ids[rows][listed].astype(np.int64))
    src, dst = np.concatenate(src), np.concatenate(dst)

    # core points within eps of each other share a component
    both = core[dst]
    graph = coo_matrix((np.ones(int(both.sum()), dtype=np.int8),
                        (src[both], dst[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # a border point belongs to the lowest-id core point listing it
    owner = np.full(n, n, dtype=np.int64)
    np.minimum.at(owner, dst[~both], src[~both])
    anchor = np.where(core, np.arange(n), owner)
    labels = np.full(n, NOISE, dtype=np.int64)
    has = anchor < n
    roots = comp[anchor[has]]
    uniq, first = np.unique(roots, return_index=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(uniq))
    labels[has] = rank[np.searchsorted(uniq, roots)]
    return labels


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    blobs = np.concatenate([
        rng.normal([0, 0], 0.3, (2000, 2)),
        rng.normal([5, 5], 0.4, (2000, 2)),
        rng.normal([0, 6], 0.2, (1500, 2)),
        rng.uniform(-3, 9, (200, 2)),           # background noise
    ]).astype(np.float32)
    labels = dbscan(blobs, eps=0.3, min_samples=10, cap=2048,
                    device=sys.argv[1] if len(sys.argv) > 1 else None)
    uniq, cnt = np.unique(labels, return_counts=True)
    print("clusters:", {int(u): int(c) for u, c in zip(uniq, cnt)})
