"""HDBSCAN's computational core on the port (``examples/hdbscan_core.py``
on ``petal_neighbors_tpu_torch``).

The reference exposes its dual-tree node accessors for petal-clustering's
HDBSCAN (ball_tree.rs:303-353).  This example gives that consumer's heavy
stages on the index's device:

* ``core_distances``: distance to the k-th neighbour of every point, one
  dual-tree self-join (``BallTree.query_tree``);
* ``mutual_reachability``: the (n, n) matrix max(core_i, core_j, d(i, j))
  from one ``pairwise`` pass and elementwise maxima;
* ``mst_edges``: Prim's minimum spanning tree over it (the single-linkage
  backbone of HDBSCAN), a loop of n-1 argmin and relax steps over (n,)
  vectors on the device, with no read back until the end.

The matrix stages take O(n^2) memory; ``mst_edges_scalable`` is the path
without the matrix (``mutual_reachability_mst``: Borůvka rounds on the
scan kernel, 1M+ points), and ``single_linkage`` / ``hdbscan_labels``
turn the MST into the dendrogram and the labels (``cluster``).

Run:  python examples/torch_hdbscan_core.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def core_distances(points, k: int, *, device=None) -> np.ndarray:
    """d(p, k-th neighbour of p), self included (HDBSCAN's core distance):
    the dual-tree all-k-NN self-join on ``device`` (None means
    ``"cuda"``)."""
    from petal_neighbors_tpu_torch import BallTree

    tree = BallTree.euclidean(np.asarray(points), device=device)
    d, _ = tree.query_tree(tree, k)
    return d[:, -1].cpu().numpy().astype(np.float64)


def _mutual_reachability_device(points, core):
    """(n, n) max(core_i, core_j, d(i, j)) with a zero diagonal, for
    ``points`` and ``core`` tensors on one device."""
    import torch

    from petal_neighbors_tpu_torch import pairwise

    d = pairwise(points)
    m = torch.maximum(d, torch.maximum(core[:, None], core[None, :]))
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    return torch.where(eye, 0.0, m)


def _core_tensors(points, k: int, device):
    import torch

    from petal_neighbors_tpu_torch.utils.validation import resolve_device

    points = np.asarray(points)
    core = core_distances(points, k, device=device).astype(points.dtype)
    dev = resolve_device(device)
    return (torch.from_numpy(points).to(dev),
            torch.from_numpy(core).to(dev))


def mutual_reachability(points, k: int, *, device=None) -> np.ndarray:
    """(n, n) mutual-reachability matrix: max(core_i, core_j, d(i, j))."""
    pts, core = _core_tensors(points, k, device)
    return _mutual_reachability_device(pts, core).cpu().numpy()


def _mst_prim_device(m):
    """Prim's MST of the dense (n, n) tensor ``m`` on its device: n-1
    argmin and relax steps over (n,) vectors, each step a few launches
    and no read back.  Returns (us, vs, ws) tensors."""
    import torch

    n = m.shape[0]
    dev = m.device
    best = m[0].clone()
    best_from = torch.zeros(n, dtype=torch.int64, device=dev)
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    in_tree[0] = True
    us = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    vs = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    ws = torch.zeros(n - 1, dtype=m.dtype, device=dev)
    for t in range(n - 1):
        j = torch.argmin(torch.where(in_tree, torch.inf, best))
        us[t] = best_from[j]
        vs[t] = j
        ws[t] = best[j]
        in_tree[j] = True
        row = m[j]
        closer = row < best
        best = torch.where(closer, row, best)
        best_from = torch.where(closer, j, best_from)
    return us, vs, ws


def mst_edges(points, k: int, *, device=None):
    """Prim's MST over mutual reachability, the HDBSCAN single-linkage
    backbone: n-1 (u, v, weight) edges.  The matrix and the MST stay on
    ``device``; only the edge list comes back."""
    pts, core = _core_tensors(points, k, device)
    us, vs, ws = _mst_prim_device(_mutual_reachability_device(pts, core))
    return [(int(u), int(v), float(w))
            for u, v, w in zip(us.cpu().numpy(), vs.cpu().numpy(),
                               ws.cpu().numpy())]


def mst_edges_scalable(points, k: int, *, leaf_size: int = 128,
                       device=None):
    """The mutual-reachability MST without the dense matrix: Borůvka
    rounds on the scan kernel (``trees.boruvka``).  Returns (us, vs, ws)
    NumPy arrays."""
    from petal_neighbors_tpu_torch import mutual_reachability_mst

    return mutual_reachability_mst(np.asarray(points), k,
                                   leaf_size=leaf_size, device=device)


def single_linkage(us, vs, ws, n: int) -> np.ndarray:
    """Scipy-format linkage matrix from MST edges (``cluster``)."""
    from petal_neighbors_tpu_torch.cluster import single_linkage as _sl

    return _sl(us, vs, ws, n)


def hdbscan_labels(points, min_cluster_size: int = 5,
                   min_samples: int | None = None, *, device=None):
    """HDBSCAN labels and membership probabilities at any scale: the MST
    on the device, the condensed tree and the excess-of-mass extraction on
    the host (``cluster.hdbscan``)."""
    from petal_neighbors_tpu_torch.cluster import hdbscan

    res = hdbscan(np.asarray(points), min_cluster_size,
                  min_samples=min_samples, device=device)
    return res.labels, res.probabilities


def demo_points() -> np.ndarray:
    """The ``__main__`` data: two Gaussian blobs."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal([0, 0], 0.3, (500, 2)),
        rng.normal([5, 5], 0.4, (500, 2)),
    ]).astype(np.float32)


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else None
    pts = demo_points()
    core = core_distances(pts, k=5, device=dev)
    print("core distance quantiles:",
          np.round(np.quantile(core, [0.1, 0.5, 0.9]), 4))
    edges = mst_edges(pts, k=5, device=dev)
    w = np.array([e[2] for e in edges])
    print(f"MST: {len(edges)} edges, max weight {w.max():.4f} "
          f"(the cluster-separating edge)")
    labels, probs = hdbscan_labels(pts, min_cluster_size=10, device=dev)
    uniq = [int(c) for c in np.unique(labels) if c >= 0]
    print(f"HDBSCAN: {len(uniq)} clusters, "
          f"{int((labels < 0).sum())} noise points, "
          f"sizes {[int((labels == c).sum()) for c in uniq]}")
