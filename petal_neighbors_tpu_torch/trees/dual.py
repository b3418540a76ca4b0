"""Batched dual-tree k-NN join over two ball trees (the JAX package's
``trees/dual.py``).

The reference exposes its node accessors (``node_distance_lower_bound``,
``children_of``, ``points_of``, ...; ball_tree.rs:303-353) so that a
consumer (petal-clustering's HDBSCAN, CHANGELOG.md:70) can run a dual-tree
traversal, pruning PAIRS of nodes with the two-ball bound
``max(d(c1, c2) − r1 − r2, 0)`` (ball_tree.rs:303-317).  The batched form
flattens the node-pair frontier:

* every LEAF PAIR bound comes from one centroid product (LA x LB);
* each A-leaf scans B-leaves best-first (ascending pair bound), a chunk a
  step, merging its members' running top-k;
* an A-leaf stops when its next pair bound exceeds the leaf's group
  threshold (the max over its members' current k-th distances).

Exact: a B-leaf is skipped for A-leaf ``a`` only when ``lb(a, b) >
max_{p in a} kth(p) >= kth(p)`` for every member p (ball_tree.rs:212-214
with both radii subtracted); bounds are deflated by a rounding slack,
NaN bounds never prune, and NaN member distances sort as farthest.

``dual_tree_knn`` picks one of three engines, as the JAX package does:
the flat index's kernel route for high-dim f32 Euclidean joins on a CUDA
index at scale (``_join_via_kernel``: capped and fold on the card), the
tile-shared single-tree scan at d <= 3 (``_join_via_tree``), and the
leaf-pair sweep (``_dual_knn``) elsewhere.  The JAX package's
``while_loop`` is a host loop here, one device-to-host read a step, and
every sort that orders leaves is stable, as ``jnp.argsort`` is: the visit
order decides which id is kept at a tie.  A kernel failure raises (the
JAX join falls back to the sweep).
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import Euclidean, Metric
from ..ops import bruteforce as bf
from ..ops.cuda.tc_planes import index_planes
from ..ops.topk import merge_topk, monotone_distances, nan_to_inf
from ..utils.tree_math import TreeShape
from .ball_query import (_bound_slack, _guarded_centroid_dist, _leaf_tables,
                         knn_query_tiled)

__all__ = ["dual_tree_knn"]

#: the kernel engine's least corpus (dual.py:374) and the tree engine's
#: (dual.py:381)
JOIN_KERNEL_MIN_N = 65536
JOIN_TREE_MIN_N = 32768

#: the latest leaf-pair sweep's counts: ``rounds`` (the doubling T0
#: rounds), ``steps`` (chunk steps summed over the launch blocks, each one
#: device-to-host read) and ``blocks`` (launch blocks)
last_sweep: dict = {}


def _kernel_available(tree) -> bool:
    """Whether the kernel engine may run: the index lies on a card."""
    return tree.device.type == "cuda"


def _leaf_row_of_pos(shape: TreeShape) -> np.ndarray:
    """(n,) row index into the (LA, MA) leaf-grouped layout for each
    permuted position (dual.py:46-52)."""
    node = np.asarray(shape.node_of_pos[shape.height - 1])
    leaf = node - shape.leaf_offset
    m = np.arange(shape.n) - shape.range_start[node]
    return (leaf * shape.max_leaf_points + m).astype(np.int64)


def _dual_knn_round(pts_a, pts_b, cb_c, rb, b_start, b_count, ca_s, ra_s,
                    apos_s, a_valid_s, all_rd, all_pp, ids, start: int, *,
                    k: int, MA: int, MB: int, C: int, n_chunks: int,
                    padB: int, LB: int, T0: int, metric: Metric):
    """Best-first chunked B-leaf scan: one bounded round (at most ``T0``
    chunk steps from chunk ``start``) for one block of A-leaf ids
    (dual.py:58-161).  The running state lives in ``all_rd``/``all_pp``
    ((LA + 1)·MA, k), updated in place at the block's rows.  Returns
    (the block's leaves still active (LAc,) bool, the steps taken)."""
    LAc = ids.shape[0]
    dev = pts_a.device
    slack = _bound_slack(pts_a.dtype)
    m_b = torch.arange(MB, device=dev)

    ca_blk, ra_blk = ca_s[ids], ra_s[ids]
    apos_blk, a_valid = apos_s[ids], a_valid_s[ids]
    rows = (ids[:, None] * MA + torch.arange(MA, device=dev)).reshape(-1)
    best_rd, best_pp = all_rd[rows], all_pp[rows]

    # leaf-pair bounds for this block's node-pair frontier
    d_cc = _guarded_centroid_dist(ca_blk, cb_c, metric)      # (LAc, LB)
    lb = torch.clamp_min(d_cc - ra_blk[:, None] - rb[None, :], 0.0)
    lb = torch.clamp_min(
        lb - slack * (d_cc + ra_blk[:, None] + rb[None, :]), 0.0)
    lb = torch.where(torch.isnan(lb), 0.0, lb)               # NaN never prunes
    lb_sorted, order = torch.sort(lb, dim=1, stable=True)
    if padB:
        # the sentinel leaf LB (start 0, count 0): padded columns add nothing
        order = torch.nn.functional.pad(order, (0, padB), value=LB)
        lb_sorted = torch.nn.functional.pad(lb_sorted, (0, padB),
                                            value=float("inf"))
    apts = pts_a[torch.where(a_valid, apos_blk, 0)]          # (LAc, MA, d)

    def active_at(best_rd, ci: int):
        """Leaves whose next pair bound is within their group threshold,
        the max member k-th distance (invalid rows give -inf)."""
        if ci >= n_chunks:
            return torch.zeros((LAc,), dtype=torch.bool, device=dev)
        kth = metric.rdistance_to_distance(
            best_rd.reshape(LAc, MA, k)[..., -1])
        tau = torch.amax(torch.where(a_valid, kth, -torch.inf), dim=1)
        return lb_sorted[:, ci * C] <= tau

    ci = start
    while ci < start + T0 and bool(torch.any(active_at(best_rd, ci))):
        b_ids = order[:, ci * C:(ci + 1) * C]                 # (LAc, C)
        bpos = b_start[b_ids][..., None] + m_b                # (LAc, C, MB)
        b_valid = m_b < b_count[b_ids][..., None]
        bpos = torch.where(b_valid, bpos, 0)
        bpts = pts_b[bpos]                                    # (LAc, C, MB, d)
        if isinstance(metric, Euclidean):
            # direct difference form: exact to rounding at any dim
            diff = apts[:, :, None, None, :] - bpts[:, None]
            rd = torch.sum(diff * diff, dim=-1)               # (LAc,MA,C,MB)
        else:
            rd = metric.rowwise_rdist(apts[:, :, None, None, :],
                                      bpts[:, None])
        rd = torch.where(b_valid[:, None], nan_to_inf(rd), torch.inf)
        rd = rd.reshape(LAc * MA, C * MB)
        pids = torch.where(b_valid, bpos, -1)[:, None].expand(
            LAc, MA, C, MB).reshape(LAc * MA, C * MB)
        best_rd, best_pp = merge_topk(rd, pids, best_rd, best_pp, k)
        ci += 1
    all_rd[rows] = best_rd
    all_pp[rows] = best_pp
    return active_at(best_rd, ci), ci - start


def _dual_finish(best_rd, best_pp, row_of_pos_a, pos_of_id_a, orig_b, *,
                 metric: Metric):
    # leaf-grouped rows -> permuted A order -> original A id order
    best_rd = best_rd[row_of_pos_a][pos_of_id_a]             # (nA, k)
    best_pp = best_pp[row_of_pos_a][pos_of_id_a]
    ids = torch.where(best_pp >= 0, orig_b[best_pp.clamp_min(0)], -1)
    return monotone_distances(metric.rdistance_to_distance(best_rd)), ids


def _dual_prep(ca, ra, cb, center, *, padA: int):
    ca_c = ca if center is None else ca - center
    cb_c = cb if center is None else cb - center
    if padA:
        # padded A-leaves are empty (count 0): tau = -inf, their loop
        # contributes nothing and their rows are dropped by _dual_finish
        ca_c = torch.nn.functional.pad(ca_c, (0, 0, 0, padA))
        ra = torch.nn.functional.pad(ra, (0, padA))
    return ca_c, cb_c, ra


def _dual_knn(pts_a, pts_b, ca, ra, cb, rb, orig_b, row_of_pos_a,
              pos_of_id_a, center, *, k: int, shape_a: TreeShape,
              shape_b: TreeShape, metric: Metric, chunk: int = 4):
    """The host loop (dual.py:186-260): (distances, B ids), both (nA, k)
    ascending in original A point order.  ``pts_a``/``pts_b`` are the
    trees' permuted points; ``ca``/``ra``/``cb``/``rb`` the leaf ball
    geometry.  Rounds of at most T0 chunk steps (T0 doubling from 8 to
    1024), the still-active A-leaf ids compacted between rounds; launch
    blocks of a power-of-two size, padded with the sentinel leaf LA.
    ``last_sweep`` records the rounds, steps and blocks."""
    global last_sweep
    dim = pts_a.shape[1]
    dev = pts_a.device
    LA, MA = shape_a.n_leaves, shape_a.max_leaf_points
    LB, MB = shape_b.n_leaves, shape_b.max_leaf_points

    C = max(1, min(chunk, LB))
    n_chunks = -(-LB // C)
    padB = n_chunks * C - LB

    # A-leaf block size: keep the (LAc, MA, C, MB, d) difference tile near
    # 256 MB f32 or below
    per_leaf = MA * C * MB * dim * 4
    LAc = int(max(1, min(LA, (1 << 28) // max(per_leaf, 1))))

    # one sentinel leaf (index LA): empty (a_valid all False, tau -inf),
    # pads ragged id blocks; its state rows are dropped by _dual_finish
    a_start, a_count = _leaf_tables(shape_a, dev)
    b_start, b_count = _leaf_tables(shape_b, dev)
    m_a = torch.arange(MA, device=dev)
    apos = torch.cat([a_start[:LA, None] + m_a,
                      torch.zeros((1, MA), dtype=m_a.dtype, device=dev)])
    a_valid = torch.cat([m_a < a_count[:LA, None],
                         torch.zeros((1, MA), dtype=torch.bool, device=dev)])

    ca_c, cb_c, ra_p = _dual_prep(ca, ra, cb, center, padA=1)

    all_rd = torch.full(((LA + 1) * MA, k), torch.inf, dtype=pts_a.dtype,
                        device=dev)
    all_pp = torch.full(((LA + 1) * MA, k), -1, dtype=torch.int64,
                        device=dev)

    act = np.arange(LA, dtype=np.int64)
    start, T0 = 0, 8
    rounds = steps = blocks = 0
    while act.size and start < n_chunks:
        LAc_r = min(LAc, max(8, 1 << (int(act.size) - 1).bit_length()))
        nblk = -(-act.size // LAc_r)
        ids_pad = np.full(nblk * LAc_r, LA, dtype=np.int64)
        ids_pad[: act.size] = act
        flags = []
        for b in range(nblk):
            ids = torch.from_numpy(ids_pad[b * LAc_r:(b + 1) * LAc_r]).to(dev)
            fl, s = _dual_knn_round(
                pts_a, pts_b, cb_c, rb, b_start, b_count, ca_c, ra_p, apos,
                a_valid, all_rd, all_pp, ids, start, k=k, MA=MA, MB=MB, C=C,
                n_chunks=n_chunks, padB=padB, LB=LB, T0=T0, metric=metric)
            flags.append(fl.cpu().numpy())
            steps += s
        blocks += nblk
        rounds += 1
        act = act[np.concatenate(flags)[: act.size]]
        start += T0
        T0 = min(2 * T0, 1024)
    last_sweep = {"rounds": rounds, "steps": steps, "blocks": blocks}
    return _dual_finish(all_rd[: LA * MA], all_pp[: LA * MA], row_of_pos_a,
                        pos_of_id_a, orig_b, metric=metric)


def _join_via_kernel(queries, points, k: int, qblock: int = 131072):
    """High-dim join engine (dual.py:263-299): the flat index's kernel
    route (``knn_prepadded``: capped or fold with the direct-form rescore,
    the proof and the repair), in query blocks.  The scheme is
    ``pick_scheme(k, n, bcap_planes=False)``: the JAX join holds no bcap
    planes.  No column padding: the port's kernels take any d."""
    n = points.shape[0]
    mu, ppad, pnorm, _ = bf.prepare_euclidean_index(points)
    planes = index_planes(ppad)
    scheme = bf.pick_scheme(k, n, bcap_planes=False)
    ds, is_ = [], []
    for s in range(0, queries.shape[0], qblock):
        d, i = bf.knn_prepadded(ppad, pnorm, queries[s:s + qblock], k, n,
                                mu, scheme=scheme, planes=planes)
        ds.append(d)
        is_.append(i)
    return torch.cat(ds), torch.cat(is_).to(torch.int32)


def _join_via_tree(tree_a, tree_b, k: int, qblock: int = 131072):
    """Low-dim join engine (dual.py:302-336): tree_b's tile-shared
    single-tree k-NN (``ball_query.knn_query_tiled``) with tree_a's points
    as the query batch, in blocks: each 256-query tile stops on its own
    members' k-th distances."""
    pts = tree_a.points
    ds, is_ = [], []
    for s in range(0, pts.shape[0], qblock):
        d, i = knn_query_tiled(
            tree_b._points_perm, tree_b._orig_ids, tree_b._leaf_centroids,
            tree_b._leaf_radii, pts[s:s + qblock], tree_b._qcenter, k=k,
            shape=tree_b._shape, metric=tree_b.metric)
        ds.append(d)
        is_.append(i)
    return torch.cat(ds), torch.cat(is_)


def dual_tree_knn(tree_a, tree_b, k: int):
    """For every point of ``tree_a``, its ``k`` nearest neighbours among
    ``tree_b``'s points (ascending; ties by merge order), as the JAX
    ``dual_tree_knn`` (dual.py:339-395).  Both trees share one metric and
    one device; a self-join (``tree_a is tree_b``) includes each point as
    its own 0-distance neighbour, HDBSCAN's core-distance convention.

    Engines: the kernel route for f32 Euclidean at d > 3, ``nB >=
    JOIN_KERNEL_MIN_N`` and ``k <= PALLAS_K_MAX`` on a CUDA index; the
    tile-shared tree scan for Euclidean at d <= 3, k <= 16 and ``nB >=
    JOIN_TREE_MIN_N``; the leaf-pair sweep otherwise.  Every engine is
    exact; only the traversal differs.

    Returns ``(distances (nA, k_eff), ids (nA, k_eff))`` in original
    ``tree_a`` point order, ids indexing ``tree_b.points``; ``k_eff =
    min(k, nB)``; ``k = 0`` gives empty tensors."""
    if type(tree_a.metric) is not type(tree_b.metric) \
            or tree_a.metric != tree_b.metric:
        raise ValueError("dual_tree_knn requires both trees to share one "
                         f"metric, got {tree_a.metric!r} vs {tree_b.metric!r}")
    if tree_a.dim != tree_b.dim:
        raise ValueError(f"dimension mismatch: {tree_a.dim} vs {tree_b.dim}")
    if tree_a.device != tree_b.device:
        raise ValueError(f"device mismatch: {tree_a.device} vs "
                         f"{tree_b.device}")
    k_eff = min(int(k), tree_b.n)
    nA = tree_a.n
    if k_eff == 0:
        return (torch.zeros((nA, 0), dtype=tree_a.points.dtype,
                            device=tree_a.device),
                torch.zeros((nA, 0), dtype=torch.int32, device=tree_a.device))
    euclid = type(tree_a.metric) is Euclidean
    if (euclid and tree_a.dim > 3
            and tree_a.points.dtype == torch.float32
            and tree_b.points.dtype == torch.float32
            and tree_b.n >= JOIN_KERNEL_MIN_N
            and k_eff <= bf.PALLAS_K_MAX and _kernel_available(tree_b)):
        return _join_via_kernel(tree_a.points, tree_b.points, k_eff)
    if euclid and tree_a.dim <= 3 and k_eff <= 16 \
            and tree_b.n >= JOIN_TREE_MIN_N:
        return _join_via_tree(tree_a, tree_b, k_eff)
    row_of_pos = torch.from_numpy(_leaf_row_of_pos(tree_a._shape)).to(
        tree_a.device)
    # the centre only moves the product-form centroid bounds; member
    # distances use the direct form
    d, i = _dual_knn(
        tree_a._points_perm, tree_b._points_perm,
        tree_a._leaf_centroids, tree_a._leaf_radii,
        tree_b._leaf_centroids, tree_b._leaf_radii,
        tree_b._orig_ids, row_of_pos, tree_a._pos_of_id, tree_a._qcenter,
        k=k_eff, shape_a=tree_a._shape, shape_b=tree_b._shape,
        metric=tree_a.metric)
    return d, i.to(torch.int32)
