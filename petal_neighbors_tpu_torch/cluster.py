"""HDBSCAN consumer pipeline: dendrogram -> condensed tree -> clusters
(the JAX package's ``cluster.py``, a NumPy copy: the port imports nothing
of the JAX package).

The reference crate exposes its ball-tree node accessors *for*
petal-clustering's HDBSCAN (ball_tree.rs:303-353, CHANGELOG.md:70 "Make
fields of `Node`, `BallTree` accessible for user").  The heavy backbone —
core distances, the mutual-reachability MST — runs on the card
(``trees.boruvka``); this module is the consumer's final product on top of
it: the single-linkage dendrogram, the Campello-Moulavi-Sander condensed
tree, cluster stabilities, and excess-of-mass (EOM) cluster extraction,
i.e. what a petal-clustering HDBSCAN user actually receives
(labels/probabilities).

These stages are O(n)–O(n log n) host-side passes over edge lists and
inherently pointer-chasing, so host numpy is the right tool: only the hot
distance work belongs on the card.

Semantics follow the published HDBSCAN* algorithm (and are oracle-tested
against sklearn.cluster.HDBSCAN at small n):

* ``single_linkage``: union-find over weight-sorted MST edges, scipy
  linkage format.
* ``condense_tree``: walk the dendrogram top-down at lambda = 1/distance;
  a split where both sides have >= ``min_cluster_size`` points creates two
  child clusters; otherwise the undersized side's points "fall out" of the
  running cluster at that lambda.
* ``cluster_stability``: sum over members of (lambda_leave - lambda_birth).
* ``extract_clusters`` (EOM): bottom-up, a cluster is selected iff its own
  stability >= the sum of its children's (ties keep the parent); selected
  ancestors absorb descendants; the root is excluded unless
  ``allow_single_cluster``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["single_linkage", "condense_tree", "cluster_stability",
           "extract_clusters", "hdbscan", "CondensedTree", "HdbscanResult"]


class CondensedTree(NamedTuple):
    """Edge list of the condensed hierarchy.

    ``parent`` is always a cluster id (>= n); ``child`` is a point id
    (< n, a point falling out of ``parent``) or a cluster id (>= n, a
    true split).  ``lam`` is the 1/distance density level of the event;
    ``size`` the number of points in ``child``.
    """

    parent: np.ndarray      # (m,) int64
    child: np.ndarray       # (m,) int64
    lam: np.ndarray         # (m,) float64
    size: np.ndarray        # (m,) int64
    n_points: int


class HdbscanResult(NamedTuple):
    labels: np.ndarray          # (n,) int64, -1 = noise
    probabilities: np.ndarray   # (n,) float64 in [0, 1]
    condensed: CondensedTree
    stabilities: dict           # selected cluster id -> stability


def single_linkage(us, vs, ws, n: int) -> np.ndarray:
    """Scipy-format linkage matrix (n-1, 4) from MST edges: the
    single-linkage dendrogram over mutual reachability — the structure
    HDBSCAN condenses into clusters.  Host union-find over the
    weight-sorted edges (O(n α(n)); the heavy lifting — the MST itself —
    stayed on device)."""
    order = np.argsort(ws, kind="stable")
    parent = np.arange(2 * n - 1)
    size = np.concatenate([np.ones(n, np.int64),
                           np.zeros(n - 1, np.int64)])
    Z = np.zeros((n - 1, 4))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    nxt = n
    for t, e in enumerate(order):
        ra, rb = find(int(us[e])), find(int(vs[e]))
        Z[t] = [min(ra, rb), max(ra, rb), ws[e], size[ra] + size[rb]]
        parent[ra] = parent[rb] = nxt
        size[nxt] = size[ra] + size[rb]
        nxt += 1
    return Z


def condense_tree(Z, min_cluster_size: int = 5) -> CondensedTree:
    """Condense a scipy-format single-linkage dendrogram.

    Top-down walk at lambda = 1/distance: when a dendrogram node splits
    into two sides of >= ``min_cluster_size`` points each, both become
    new clusters; an undersized side's points fall out of the running
    cluster at the split's lambda.  O(n): every dendrogram node is
    visited once and every point falls out exactly once.
    """
    if min_cluster_size < 2:
        raise ValueError("min_cluster_size must be >= 2")
    Z = np.asarray(Z)
    n = Z.shape[0] + 1
    left = Z[:, 0].astype(np.int64)
    right = Z[:, 1].astype(np.int64)
    dist = Z[:, 2].astype(np.float64)
    with np.errstate(divide="ignore"):
        lam_split = np.where(dist > 0.0, 1.0 / np.maximum(dist, 1e-300),
                             np.inf)
    sizes = np.concatenate([np.ones(n, np.int64),
                            Z[:, 3].astype(np.int64)])

    def leaves_under(node: int) -> list:
        out, stack = [], [node]
        while stack:
            x = stack.pop()
            if x < n:
                out.append(x)
            else:
                t = x - n
                stack.append(int(left[t]))
                stack.append(int(right[t]))
        return out

    parents, children, lams, szs = [], [], [], []
    root = 2 * n - 2
    next_label = n + 1
    # (dendrogram node, current condensed-cluster label) — queued nodes
    # are always internal: a side with >= min_cluster_size >= 2 points.
    # FIFO = BFS order, so new cluster labels are numbered breadth-first
    # (the convention sklearn's condensed tree uses, making label ids
    # directly comparable in the oracle tests)
    from collections import deque

    stack = deque([(root, n)])
    while stack:
        node, cl = stack.popleft()
        t = node - n
        lam = float(lam_split[t])
        for side in (int(left[t]), int(right[t])):
            if sizes[side] >= min_cluster_size:
                continue
            for p in leaves_under(side):
                parents.append(cl)
                children.append(p)
                lams.append(lam)
                szs.append(1)
        big = [s for s in (int(left[t]), int(right[t]))
               if sizes[s] >= min_cluster_size]
        if len(big) == 2:
            for s in big:
                parents.append(cl)
                children.append(next_label)
                lams.append(lam)
                szs.append(int(sizes[s]))
                stack.append((s, next_label))
                next_label += 1
        elif len(big) == 1:
            stack.append((big[0], cl))
    return CondensedTree(np.asarray(parents, np.int64),
                         np.asarray(children, np.int64),
                         np.asarray(lams, np.float64),
                         np.asarray(szs, np.int64), n)


def cluster_stability(ct: CondensedTree) -> dict:
    """Stability of every condensed cluster: sum over child rows of
    (lambda_leave - lambda_birth) * size, where a cluster's birth lambda
    is the lambda of the row that created it (0 for the root)."""
    births = {int(c): float(l) for c, l in zip(ct.child, ct.lam)
              if c >= ct.n_points}
    births[ct.n_points] = 0.0
    stab: dict = {}
    for p, l, s in zip(ct.parent, ct.lam, ct.size):
        p = int(p)
        stab[p] = stab.get(p, 0.0) + (float(l) - births[p]) * int(s)
    return stab


def extract_clusters(ct: CondensedTree, *,
                     allow_single_cluster: bool = False):
    """Excess-of-mass cluster selection over a condensed tree.

    Returns (labels (n,) int64 with -1 noise, probabilities (n,) float64,
    stabilities {selected cluster id -> stability}).  Bottom-up: a
    cluster keeps its own stability iff it is >= the sum of its
    children's final stabilities (ties keep the parent, matching the
    published algorithm); a selected cluster deselects every descendant.
    The root is never selected unless ``allow_single_cluster``.
    """
    n = ct.n_points
    stab = cluster_stability(ct)
    is_cluster_row = ct.child >= n
    cparent = ct.parent[is_cluster_row].astype(np.int64)
    cchild = ct.child[is_cluster_row].astype(np.int64)
    kids: dict = {}
    par_of: dict = {}
    for p, c in zip(cparent, cchild):
        kids.setdefault(int(p), []).append(int(c))
        par_of[int(c)] = int(p)

    clusters = sorted(stab.keys(), reverse=True)   # deepest labels first
    selected = {c: True for c in clusters}
    final = dict(stab)
    for c in clusters:
        if c == n and not allow_single_cluster:
            selected[c] = False
            continue
        ch = kids.get(c, ())
        subtree = sum(final[x] for x in ch)
        if ch and subtree > final[c]:
            selected[c] = False
            final[c] = subtree
        elif selected[c]:
            # deselect every descendant cluster (bottom-up order makes
            # one BFS here O(total subtree sizes) = O(n) overall worst
            # case; in practice selected clusters are near the leaves)
            stack = list(ch)
            while stack:
                x = stack.pop()
                selected[x] = False
                stack.extend(kids.get(x, ()))

    # selected ancestor per cluster, top-down (parents precede children
    # in ascending label order by construction)
    sel_anc = {}
    for c in sorted(stab.keys()):
        if selected.get(c, False):
            sel_anc[c] = c
        else:
            sel_anc[c] = sel_anc.get(par_of.get(c, -1), -1)

    point_rows = ~is_cluster_row
    p_cl = ct.parent[point_rows].astype(np.int64)
    p_id = ct.child[point_rows].astype(np.int64)
    p_lam = ct.lam[point_rows]
    owner = np.asarray([sel_anc.get(int(c), -1) for c in p_cl],
                       np.int64)

    sel_ids = sorted(c for c in stab if selected.get(c, False))
    label_of = {c: i for i, c in enumerate(sel_ids)}
    labels = np.full(n, -1, np.int64)
    probs = np.zeros(n, np.float64)
    # per selected cluster: max fall-out lambda over its absorbed points
    max_lam = {c: 0.0 for c in sel_ids}
    for c, l in zip(owner, p_lam):
        if c >= 0:
            v = float(l)
            if v > max_lam[int(c)]:
                max_lam[int(c)] = v
    for pid, c, l in zip(p_id, owner, p_lam):
        if c < 0:
            continue
        labels[pid] = label_of[int(c)]
        m = max_lam[int(c)]
        if m == 0.0 or not np.isfinite(m):
            probs[pid] = 1.0
        else:
            probs[pid] = min(float(l), m) / m
    stabilities = {c: final[c] for c in sel_ids}
    return labels, probs, stabilities


def hdbscan(points, min_cluster_size: int = 5,
            min_samples: int | None = None, *, scheme: str = "auto",
            allow_single_cluster: bool = False, device=None) -> HdbscanResult:
    """End-to-end HDBSCAN: the mutual-reachability MST on ``device``
    (``trees.boruvka``, no dense matrix — 1M+ points) + host condensed
    tree and EOM extraction.  ``min_samples`` defaults to
    ``min_cluster_size`` (the sklearn convention); core distances count
    the point itself, matching sklearn's kneighbors-on-train convention.
    ``points`` is an (n, d) NumPy array or tensor; ``device=None`` means
    ``"cuda"`` and raises without a card.
    """
    from .trees.boruvka import mutual_reachability_mst
    from .utils.validation import resolve_device

    dev = resolve_device(device)
    n = points.shape[0]
    if min_samples is None:
        min_samples = min_cluster_size
    if n < 2 or n < min_cluster_size:
        ct = CondensedTree(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0), np.zeros(0, np.int64), n)
        return HdbscanResult(np.full(n, -1, np.int64), np.zeros(n), ct, {})
    us, vs, ws = mutual_reachability_mst(points, min_samples, scheme=scheme,
                                         device=dev)
    Z = single_linkage(us, vs, ws, n)
    ct = condense_tree(Z, min_cluster_size)
    labels, probs, stabilities = extract_clusters(
        ct, allow_single_cluster=allow_single_cluster)
    return HdbscanResult(labels, probs, ct, stabilities)
