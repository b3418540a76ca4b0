"""OPTICS on the port's batched k-NN and radius search
(``examples/optics.py`` on ``petal_neighbors_tpu_torch``).

* core distances: each point's ``min_samples``-th neighbour (self
  included) from one batched k-NN sweep on the device;
* the eps-neighbour lists: batched capped radius queries on the device;
* the reachability walk (a priority queue popping one point at a time),
  sequential by nature, on the host.

Output follows the classic contract: a processing ``ordering``, per-point
``reachability`` (inf at each component's seed) and ``core_dist`` (inf
where the eps-neighbourhood holds fewer than ``min_samples`` points).

Run:  python examples/torch_optics.py
"""

from __future__ import annotations

import heapq
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def optics(points, eps: float, min_samples: int, *, batch: int = 4096,
           cap: int = 1024, device=None):
    """Exact OPTICS (ordering, reachability, core_dist), as
    ``examples/optics.py``.

    Seeds are the smallest-id unprocessed points and the priority queue
    breaks reachability ties by id: one fixed order.  The device finds the
    neighbours; every distance the walk compares, the core distances
    included, is recomputed in f64 on the host from the points, so the
    result is the same bits on any device (the JAX example takes its core
    distances from the device's k-NN).  Neighbourhoods follow the
    ``BallTree`` radius rules (ball_tree.rs:271-277), while the core test
    is inclusive (k-th distance <= eps).  ``device``: where the tree lives
    (None means ``"cuda"``).
    """
    from petal_neighbors_tpu_torch import BallTree

    points = np.asarray(points)
    n = points.shape[0]
    tree = BallTree.euclidean(points, device=device)

    # device pass 1: each point's min_samples-th neighbour from one batched
    # k-NN sweep; its distance in f64 on the host, as the walk's own
    pts64 = points.astype(np.float64)
    core_dist = np.full(n, np.inf)
    if n >= min_samples:                        # else undefined everywhere
        for s in range(0, n, batch):
            kth = tree.query_batch(points[s:s + batch], min_samples)[1]
            kth = kth[:, -1].cpu().numpy()
            core_dist[s:s + batch] = np.sqrt(
                ((pts64[kth] - pts64[s:s + batch]) ** 2).sum(1))
    core_dist[core_dist > eps] = np.inf         # undefined past eps

    # device pass 2: capped eps-neighbour lists
    nbr_list = []
    for s in range(0, n, batch):
        ids, cnts = tree.query_radius_batch(points[s:s + batch], eps,
                                            cap=cap)
        cnts = cnts.cpu().numpy()
        if (cnts > cap).any():
            raise ValueError(
                f"neighbor cap {cap} exceeded (max {int(cnts.max())}); "
                "raise `cap`")
        nbr_list.append(ids.cpu().numpy())
    nbr_ids = np.concatenate(nbr_list, axis=0)

    # host walk: the classic OPTICS priority-queue expansion
    reach = np.full(n, np.inf)
    processed = np.zeros(n, dtype=bool)
    ordering = []
    heap = []       # (reachability, id): the id breaks ties

    def update_from(p: int):
        if not np.isfinite(core_dist[p]):
            return
        nbrs = nbr_ids[p]
        nbrs = nbrs[nbrs >= 0]
        nbrs = nbrs[~processed[nbrs]]
        if nbrs.size == 0:
            return
        d = np.sqrt(((pts64[nbrs] - pts64[p]) ** 2).sum(1))
        newreach = np.maximum(core_dist[p], d)
        better = newreach < reach[nbrs]
        for o, r in zip(nbrs[better], newreach[better]):
            reach[o] = r
            heapq.heappush(heap, (r, int(o)))

    for seed in range(n):
        if processed[seed]:
            continue
        processed[seed] = True
        ordering.append(seed)
        update_from(seed)
        while heap:
            r, p = heapq.heappop(heap)
            if processed[p] or r > reach[p]:
                continue            # a stale entry (lazy deletion)
            processed[p] = True
            ordering.append(p)
            update_from(p)

    return np.asarray(ordering), reach, core_dist


def extract_dbscan(ordering, reach, core_dist, eps_prime: float):
    """DBSCAN-equivalent labels from an OPTICS result: a cluster starts
    where reachability exceeds ``eps_prime`` at a point that is core at
    ``eps_prime``."""
    labels = np.full(len(ordering), -1, dtype=np.int64)
    cid = -1
    for p in ordering:
        if reach[p] > eps_prime:
            if core_dist[p] <= eps_prime:
                cid += 1
                labels[p] = cid
        else:
            labels[p] = cid
    return labels


def demo_points() -> np.ndarray:
    """The ``__main__`` data: three blobs and background noise."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal([0, 0], 0.3, (2000, 2)),
        rng.normal([5, 5], 0.4, (2000, 2)),
        rng.normal([0, 6], 0.2, (1500, 2)),
        rng.uniform(-3, 9, (200, 2)),           # background noise
    ]).astype(np.float32)


if __name__ == "__main__":
    blobs = demo_points()
    ordering, reach, core = optics(
        blobs, eps=1.0, min_samples=10, cap=4096,
        device=sys.argv[1] if len(sys.argv) > 1 else None)
    labels = extract_dbscan(ordering, reach, core, 0.3)
    uniq, cnt = np.unique(labels, return_counts=True)
    print("clusters:", {int(u): int(c) for u, c in zip(uniq, cnt)})
    finite = np.isfinite(reach)
    print(f"reachability: median {np.median(reach[finite]):.3f}, "
          f"{finite.sum()} reachable of {len(blobs)}")
