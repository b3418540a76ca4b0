"""Batched ball-tree queries (the JAX package's ``trees/ball_query.py``).

The reference's pointer-chasing branch-and-bound with a binary heap
(ball_tree.rs:149-294) becomes two lockstep batched schemes:

* **k-NN** — a best-first chunked leaf scan: one product gives every
  query's lower bound to every leaf ball; each query visits its leaves in
  ascending bound order, ``chunk_leaves`` at a time, merging into a
  running top-k, until every query's next bound exceeds its k-th
  distance.  Exact by the reference's argument (prune only when lb >
  k-th best, ball_tree.rs:212-214); only the visit order differs.  The
  JAX package's ``lax.while_loop`` is a host loop here with the same stop
  test, one device-to-host read per step.

* **radius** — mask algebra over the node table: the direct-form bounds
  of every node, the traversal's reachability level by level, then
  membership = "a reached ancestor lay wholly inside" OR "the leaf was
  scanned AND d < r": the whole-subtree take is inclusive (``ub <= r``)
  and the leaf filter strict (``d < r``), as ball_tree.rs:271-277.

Every sort that orders leaves or queries is stable, as ``jnp.argsort``
is: the visit order decides which id is kept at a tie on the k-th
distance.  The bound products run in full FP32 on the card
(``distance._cross``): their rounding guards hold for no TF32 product.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import DIRECT_DIM_MAX, Euclidean, Metric, _cross
from ..ops.bruteforce import append_ids, direct_rdist
from ..ops.topk import (merge_topk, monotone_distances, nan_to_inf,
                        rescore_exact)
from ..utils.tree_math import TreeShape

__all__ = ["knn_query", "knn_query_tiled", "radius_query_mask",
           "radius_query_capped", "radius_query_capped_tiled"]


def _bound_slack(dtype) -> float:
    """Relative slack subtracted from lower bounds so that the product
    form's rounding never prunes falsely."""
    return 4e-6 if dtype == torch.float32 else 1e-13


def _guarded_centroid_dist(queries, centroids, metric: Metric):
    """Centroid distances for pruning bounds (ball_query.py:47-69): for
    Euclidean the ``‖q‖² + ‖c‖² − 2 q·c`` product, less its rounding
    bound ``4·eps·(‖q‖² + ‖c‖²)`` before the sqrt, so that the result is a
    valid lower bound on the true distance."""
    if not isinstance(metric, Euclidean):
        return metric.rdistance_to_distance(metric.rdist(queries, centroids))
    qn = torch.sum(queries * queries, dim=-1)[:, None]
    cn = torch.sum(centroids * centroids, dim=-1)[None, :]
    rd = qn + cn - 2.0 * _cross(queries, centroids)
    guard = 4.0 * torch.finfo(queries.dtype).eps * (qn + cn)
    return torch.sqrt(torch.clamp_min(rd - guard, 0.0))


def _leaf_tables(shape: TreeShape, device):
    """Leaf starts and counts, with a sentinel row (start 0, count 0) at
    index L for chunk padding."""
    lo = shape.n_leaves - 1
    starts = shape.range_start[lo:]
    counts = shape.range_end[lo:] - starts
    return (torch.from_numpy(np.concatenate([starts, [0]])).to(device),
            torch.from_numpy(np.concatenate([counts, [0]])).to(device))


def _leaf_bounds(qc, lc, leaf_radii, metric: Metric, dtype):
    """(Q, L) lower bounds to every leaf ball, deflated by the slack; NaN
    bounds never prune (NaN > r is false in the reference), so they are
    0."""
    d_c = _guarded_centroid_dist(qc, lc, metric)
    lb = torch.clamp_min(d_c - leaf_radii[None, :], 0.0)
    lb = torch.clamp_min(
        lb - _bound_slack(dtype) * (d_c + leaf_radii[None, :]), 0.0)
    return torch.where(torch.isnan(lb), 0.0, lb)


def _pad_chunks(order, lb_sorted, L: int, C: int):
    """Pad the visit order to whole chunks with the sentinel leaf L at a
    +inf bound."""
    pad = -(-L // C) * C - L
    if pad:
        order = torch.nn.functional.pad(order, (0, pad), value=L)
        lb_sorted = torch.nn.functional.pad(lb_sorted, (0, pad),
                                            value=float("inf"))
    return order, lb_sorted


def _gather_leaves(leaf_ids, leaf_start, leaf_count, max_leaf: int):
    """Permuted positions (..., C, M) of the leaves' members and their
    validity; invalid slots point at row 0."""
    m_ar = torch.arange(max_leaf, device=leaf_ids.device)
    pos = leaf_start[leaf_ids][..., None] + m_ar
    valid = m_ar < leaf_count[leaf_ids][..., None]
    return torch.where(valid, pos, 0), valid


def knn_query(points_perm, perm_norms, orig_ids, leaf_centroids, leaf_radii,
              queries, center=None, *, k: int, shape: TreeShape,
              metric: Metric, chunk_leaves: int = 4,
              with_stats: bool = False):
    """Exact batched k-NN over a built ball tree (ball_query.py:84-213).

    ``points_perm`` (n, d) are the points in tree (idx) order,
    ``perm_norms`` the squared norms of their centred copy (Euclidean) or
    None, ``orig_ids`` (n,) the original id at each position, and
    ``center`` (d,) the data mean or None: every product-form computation
    (bounds, the leaf scan at d > 32) runs on centred values, and the
    final direct-form rescore on the original ones.  The caller
    guarantees 1 <= k <= n.  Returns (distances, ids (int32)), (Q, k)
    ascending, and with ``with_stats`` a dict: n_leaves, loop_chunks,
    chunk_leaves, leaves_surviving_final_bound, prune_ratio."""
    n, dim = points_perm.shape
    q = queries.shape[0]
    L = shape.n_leaves
    dtype, dev = points_perm.dtype, points_perm.device
    qc = queries if center is None else queries - center
    lc = leaf_centroids if center is None else leaf_centroids - center

    lb = _leaf_bounds(qc, lc, leaf_radii, metric, dtype)
    lb_sorted, order = torch.sort(lb, dim=1, stable=True)   # best-first
    C = max(1, min(chunk_leaves, L))
    n_chunks = -(-L // C)
    order, lb_sorted = _pad_chunks(order, lb_sorted, L, C)
    leaf_start, leaf_count = _leaf_tables(shape, dev)

    use_norms = isinstance(metric, Euclidean) and perm_norms is not None
    if use_norms:
        qn = torch.sum(qc * qc, dim=-1)
    # high-dim Euclidean: the product form loses accuracy at tiny
    # distances, so keep a slack of candidates and rescore them exactly
    do_rescore = isinstance(metric, Euclidean) and dim > DIRECT_DIM_MAX
    k_scan = min(k + 8, n) if do_rescore else k

    best_rd = torch.full((q, k_scan), torch.inf, dtype=dtype, device=dev)
    best_pos = torch.full((q, k_scan), -1, dtype=torch.int64, device=dev)
    ci = 0
    while ci < n_chunks and bool(torch.any(
            lb_sorted[:, ci * C]
            <= metric.rdistance_to_distance(best_rd[:, -1]))):
        pos, valid = _gather_leaves(order[:, ci * C:(ci + 1) * C],
                                    leaf_start, leaf_count,
                                    shape.max_leaf_points)
        pts = points_perm[pos]                               # (Q, C, M, d)
        if do_rescore and use_norms:
            # the matmul form on centred values (perm_norms are centred)
            pts_c = pts if center is None else pts - center
            if pts_c.is_cuda:
                torch.backends.cuda.matmul.allow_tf32 = False
            cross = torch.einsum("qd,qcmd->qcm", qc, pts_c)
            rd = torch.clamp_min(qn[:, None, None] + perm_norms[pos]
                                 - 2.0 * cross, 0.0)
        else:
            # Euclidean's is the direct form: exact to rounding, and
            # faster than a product over d <= 32 (distance.DIRECT_DIM_MAX)
            rd = metric.rowwise_rdist(queries[:, None, None, :], pts)
        rd = torch.where(valid, nan_to_inf(rd), torch.inf).reshape(q, -1)
        pids = torch.where(valid, pos, -1).reshape(q, -1)
        best_rd, best_pos = merge_topk(rd, pids, best_rd, best_pos, k_scan)
        ci += 1

    if do_rescore:
        # exact rescore on the original (uncentred) values
        best_rd, best_pos = rescore_exact(points_perm, queries, best_pos, k)
    best_ii = torch.where(best_pos >= 0, orig_ids[best_pos.clamp_min(0)], -1)
    dists = monotone_distances(metric.rdistance_to_distance(best_rd))
    if not with_stats:
        return dists, best_ii
    surviving = torch.sum(lb <= dists[:, -1:], dim=1, dtype=torch.int32)
    stats = {"n_leaves": L, "loop_chunks": ci, "chunk_leaves": C,
             "leaves_surviving_final_bound": surviving,
             "prune_ratio": 1.0 - surviving / L}
    return dists, best_ii, stats


def _merge_small_k(rd, ids, best_rd, best_ii, k: int):
    """The running top-k merge by k passes of min-extraction
    (ball_query.py:216-233): each pass takes the first minimum of the
    row and sets it to +inf.  Where fewer than k entries are finite, the
    passes after them take column 0 again, as the JAX package's do."""
    d = torch.cat([rd, best_rd], dim=-1)
    i = torch.cat([ids, best_ii], dim=-1)
    out_d, out_i = [], []
    for _ in range(k):
        am = torch.argmin(d, dim=-1, keepdim=True)
        out_d.append(torch.gather(d, -1, am))
        out_i.append(torch.gather(i, -1, am))
        d = d.scatter(-1, am, torch.inf)
    return torch.cat(out_d, dim=-1), torch.cat(out_i, dim=-1)


def _locality_order(key, q: int, tq: int):
    """Queries stably sorted by ``key`` and padded to whole tiles with
    repeats of the last one: (order (T·tq,), T)."""
    T = -(-q // tq)
    order = torch.sort(key, stable=True).indices
    if T * tq > q:
        order = torch.cat([order, order[-1:].expand(T * tq - q)])
    return order, T


def _unpermute(order, q: int):
    """The inverse of a locality order: a query's padded repeats sit in its
    own tile and give its own results, so any of them may stand."""
    inv = torch.empty((q,), dtype=torch.int64, device=order.device)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def _tile_rdist(qs_t, pts, metric: Metric):
    """(T, tq, R) reduced distances of each tile's queries (T, tq, d) to
    its rows (T, R, d), as ``metric.rdist`` per tile: for Euclidean the
    direct form at d <= 32 and the uncentred matmul form above (with no
    rescore, as the JAX package's tiled scheme)."""
    if isinstance(metric, Euclidean) and qs_t.shape[-1] > DIRECT_DIM_MAX:
        if pts.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        qn = torch.sum(qs_t * qs_t, dim=-1)[..., None]
        xn = torch.sum(pts * pts, dim=-1)[:, None, :]
        return torch.clamp_min(
            qn + xn - 2.0 * torch.bmm(qs_t, pts.transpose(1, 2)), 0.0)
    return metric.rowwise_rdist(qs_t[:, :, None, :], pts[:, None, :, :])


def knn_query_tiled(points_perm, orig_ids, leaf_centroids, leaf_radii,
                    queries, center=None, *, k: int,
                    shape: TreeShape, metric: Metric,
                    chunk_leaves: int = 4, tile_q: int = 256,
                    with_stats: bool = False):
    """Exact batched k-NN with a tile-shared leaf frontier
    (ball_query.py:238-372).  Queries are sorted by locality (their
    best-bound leaf), and each tile of ``tile_q`` shares one visit order,
    ascending in the tile's least bound: one gather of (T, C, M, d) serves
    the whole tile.  The loop stops when, for every query, the tile's next
    bound exceeds its k-th distance; a tile's bound is at most each
    member's, so every leaf the reference would scan is scanned.  The
    merge is ``_merge_small_k``, for small k.  Returns (distances, ids)
    in the caller's query order, and with ``with_stats`` a dict:
    n_leaves, loop_chunks, chunk_leaves, n_tiles."""
    q, dim = queries.shape
    L = shape.n_leaves
    dtype, dev = points_perm.dtype, points_perm.device
    qc = queries if center is None else queries - center
    lc = leaf_centroids if center is None else leaf_centroids - center
    lb = _leaf_bounds(qc, lc, leaf_radii, metric, dtype)

    tq = max(1, min(tile_q, q))
    qorder, T = _locality_order(torch.argmin(lb, dim=1), q, tq)
    qs_t = queries[qorder].reshape(T, tq, dim)
    lb_tile = torch.amin(lb[qorder].reshape(T, tq, L), dim=1)    # (T, L)
    lbt_sorted, order_t = torch.sort(lb_tile, dim=1, stable=True)
    C = max(1, min(chunk_leaves, L))
    n_chunks = -(-L // C)
    order_t, lbt_sorted = _pad_chunks(order_t, lbt_sorted, L, C)
    leaf_start, leaf_count = _leaf_tables(shape, dev)

    best_rd = torch.full((T, tq, k), torch.inf, dtype=dtype, device=dev)
    best_pos = torch.full((T, tq, k), -1, dtype=torch.int64, device=dev)
    ci = 0
    while ci < n_chunks and bool(torch.any(
            lbt_sorted[:, ci * C, None]
            <= metric.rdistance_to_distance(best_rd[..., -1]))):
        pos, valid = _gather_leaves(order_t[:, ci * C:(ci + 1) * C],
                                    leaf_start, leaf_count,
                                    shape.max_leaf_points)   # (T, C, M)
        rd = _tile_rdist(qs_t, points_perm[pos].reshape(T, -1, dim), metric)
        rd = torch.where(valid.reshape(T, 1, -1), nan_to_inf(rd), torch.inf)
        pids = torch.where(valid, pos, -1).reshape(T, 1, -1).expand_as(rd)
        best_rd, best_pos = _merge_small_k(rd, pids, best_rd, best_pos, k)
        ci += 1

    inv = _unpermute(qorder, q)
    best_rd = best_rd.reshape(T * tq, k)[inv]
    best_pos = best_pos.reshape(T * tq, k)[inv]
    best_ii = torch.where(best_pos >= 0, orig_ids[best_pos.clamp_min(0)], -1)
    dists = monotone_distances(metric.rdistance_to_distance(best_rd))
    if not with_stats:
        return dists, best_ii
    stats = {"n_leaves": L, "loop_chunks": ci, "chunk_leaves": C,
             "n_tiles": T}
    return dists, best_ii, stats


def _direct_dist_chunked(queries, rows, metric: Metric, chunk: int):
    """(Q, m) distances by the direct difference form, over row chunks
    (ball_query.py:375-399): the radius boundary rules need the
    reference's own arithmetic, not the product form's cancellation."""
    out = torch.empty((queries.shape[0], rows.shape[0]), dtype=rows.dtype,
                      device=rows.device)
    c = max(1, min(chunk, rows.shape[0]))
    for s in range(0, rows.shape[0], c):
        out[:, s:s + c] = metric.rdistance_to_distance(
            direct_rdist(queries, rows[s:s + c], metric))
    return out


def _radius_leaf_flags(queries, centroids, radii, r, shape: TreeShape,
                       metric: Metric, chunk: int):
    """Per-leaf radius flags (ball_query.py:481-514): (take_leaf,
    scan_leaf), each (Q, L).  take_leaf: the leaf or an ancestor was taken
    whole (``ub <= r``), every member is in with no distance test;
    scan_leaf: the traversal reached the leaf and it needs the strict
    ``d < r`` filter.  The comparisons are negated so that NaN bounds
    descend, as the reference's ``NaN > r == false``."""
    q = queries.shape[0]
    d_node = _direct_dist_chunked(queries, centroids, metric, chunk)
    lb = torch.clamp_min(d_node - radii[None, :], 0.0)
    ub = d_node + radii[None, :]
    descend = ~(lb > r) & ~(ub <= r)
    reached_lvl = [torch.ones((q, 1), dtype=torch.bool,
                              device=queries.device)]
    for level in range(1, shape.height):
        lo, hi = (1 << level) - 1, (1 << (level + 1)) - 1
        parents = torch.from_numpy((np.arange(lo, hi) - 1) // 2).to(
            queries.device)
        reached_lvl.append(
            reached_lvl[level - 1][:, parents - ((1 << (level - 1)) - 1)]
            & descend[:, parents])
    reached = torch.cat(reached_lvl, dim=1)
    take_all = reached & (ub <= r)
    leaf_lo = shape.n_leaves - 1
    scan_leaf = (reached[:, leaf_lo:] & ~(lb[:, leaf_lo:] > r)
                 & ~(ub[:, leaf_lo:] <= r))
    # a leaf is taken where any ancestor (itself included) was
    anc = np.arange(leaf_lo, shape.n_nodes)
    take_leaf = torch.zeros((q, shape.n_leaves), dtype=torch.bool,
                            device=queries.device)
    for _ in range(shape.height):
        take_leaf |= take_all[:, torch.from_numpy(anc).to(queries.device)]
        anc = (anc - 1) // 2
    return take_leaf, scan_leaf


def radius_query_mask(points_perm, orig_pos_of_id, centroids, radii,
                      queries, radius, *, shape: TreeShape, metric: Metric,
                      point_chunk: int = 65536):
    """Batched radius search as a (Q, n) mask in original id order
    (ball_query.py:403-478), with the reference's boundary rules: the
    inclusive subtree take and the strict leaf filter.  Every distance is
    the direct form.  A position is taken when its leaf was
    (``_radius_leaf_flags``: the leaf or an ancestor), which is the JAX
    package's union over the levels' taken nodes.  ``orig_pos_of_id[j]``
    is the permuted position of original point j."""
    n = points_perm.shape[0]
    q = queries.shape[0]
    r = torch.as_tensor(radius, dtype=points_perm.dtype,
                        device=points_perm.device)
    take_leaf, scan_leaf = _radius_leaf_flags(queries, centroids, radii, r,
                                              shape, metric, point_chunk)
    leaf_of_pos = torch.from_numpy(
        shape.node_of_pos[shape.height - 1].astype(np.int64)
        - (shape.n_leaves - 1)).to(points_perm.device)
    rr = metric.distance_to_rdistance(r)
    member = torch.empty((q, n), dtype=torch.bool, device=points_perm.device)
    c = max(1, min(point_chunk, n))
    for s in range(0, n, c):
        leaf = leaf_of_pos[s:s + c]
        within = nan_to_inf(direct_rdist(queries, points_perm[s:s + c],
                                         metric)) < rr       # strict (:277)
        member[:, s:s + c] = take_leaf[:, leaf] | (scan_leaf[:, leaf]
                                                   & within)
    return member[:, orig_pos_of_id]


def radius_query_capped(points_perm, orig_ids, centroids, radii, queries,
                        radius, *, shape: TreeShape, metric: Metric,
                        cap: int, chunk_leaves: int = 1,
                        point_chunk: int = 65536):
    """Tree-pruned batched radius search with capped id lists
    (ball_query.py:519-624): each query gathers only the leaves its
    traversal emits, in groups of ``chunk_leaves`` consecutive leaves (a
    group's non-emitted leaves are masked), emitted groups first.  Same
    membership as ``radius_query_mask``.  Returns (ids (Q, cap) int32
    original ids in traversal order, -1 padded; counts (Q,) int32, exact
    past the cap)."""
    q = queries.shape[0]
    dev = points_perm.device
    r = torch.as_tensor(radius, dtype=points_perm.dtype, device=dev)
    rr = metric.distance_to_rdistance(r)
    L = shape.n_leaves
    take_leaf, scan_leaf = _radius_leaf_flags(queries, centroids, radii, r,
                                              shape, metric, point_chunk)
    emit = take_leaf | scan_leaf
    C = max(1, min(chunk_leaves, L))
    G = -(-L // C)
    emit_g = torch.nn.functional.pad(emit, (0, G * C - L)).reshape(
        q, G, C).any(-1)
    order = torch.sort((~emit_g).to(torch.uint8), dim=1, stable=True).indices
    emit_sorted = torch.gather(emit_g, 1, order)
    leaf_start, leaf_count = _leaf_tables(shape, dev)
    # the flag tables gain the sentinel leaf's column (never emitted)
    take_pad = torch.nn.functional.pad(take_leaf, (0, 1))
    scan_pad = torch.nn.functional.pad(scan_leaf, (0, 1))
    c_ar = torch.arange(C, device=dev)

    out = torch.full((q, cap + 1), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((q,), dtype=torch.int64, device=dev)
    ci = 0
    while ci < G and bool(torch.any(emit_sorted[:, ci])):
        leaf_ids = torch.clamp_max(order[:, ci:ci + 1] * C + c_ar, L)
        taken = torch.gather(take_pad, 1, leaf_ids)           # (Q, C)
        scanned = torch.gather(scan_pad, 1, leaf_ids)
        pos, valid = _gather_leaves(leaf_ids, leaf_start, leaf_count,
                                    shape.max_leaf_points)    # (Q, C, M)
        valid &= (taken | scanned)[..., None]
        rd = metric.rowwise_rdist(queries[:, None, None, :], points_perm[pos])
        accept = valid & (taken[..., None] | (nan_to_inf(rd) < rr))
        cnt = append_ids(out, cnt, accept.reshape(q, -1),
                         orig_ids[pos].reshape(q, -1))
        ci += 1
    return out[:, :cap], cnt.to(torch.int32)


def radius_query_capped_tiled(points_perm, orig_ids, centroids, radii,
                              queries, radius, *, shape: TreeShape,
                              metric: Metric, cap: int,
                              chunk_leaves: int = 8, tile_q: int = 128,
                              point_chunk: int = 65536):
    """``radius_query_capped`` with a tile-shared leaf frontier
    (ball_query.py:629-753): queries sorted by locality (their first
    emitted leaf), each tile of ``tile_q`` visiting the union of its
    members' emitted leaves in one order.  Each member accepts a point
    only by its own leaf flags, so membership is the per-query scheme's;
    counts are exact past the cap, ids in traversal order."""
    q, dim = queries.shape
    dev = points_perm.device
    r = torch.as_tensor(radius, dtype=points_perm.dtype, device=dev)
    rr = metric.distance_to_rdistance(r)
    L = shape.n_leaves
    take_leaf, scan_leaf = _radius_leaf_flags(queries, centroids, radii, r,
                                              shape, metric, point_chunk)
    emit = take_leaf | scan_leaf

    tq = max(1, min(tile_q, q))
    qorder, T = _locality_order(
        torch.argmax(emit.to(torch.uint8), dim=1), q, tq)
    qs_t = queries[qorder].reshape(T, tq, dim)
    # per-member flags in tile order, with the sentinel leaf's column L
    take_s = torch.nn.functional.pad(take_leaf, (0, 1))[qorder].reshape(
        T, tq, L + 1)
    scan_s = torch.nn.functional.pad(scan_leaf, (0, 1))[qorder].reshape(
        T, tq, L + 1)
    emit_tile = torch.any((take_s | scan_s)[:, :, :L], dim=1)     # (T, L)
    order_t = torch.sort((~emit_tile).to(torch.uint8), dim=1,
                         stable=True).indices
    emit_sorted = torch.gather(emit_tile, 1, order_t)
    C = max(1, min(chunk_leaves, L))
    n_chunks = -(-L // C)
    pad = n_chunks * C - L
    if pad:
        order_t = torch.nn.functional.pad(order_t, (0, pad), value=L)
        emit_sorted = torch.nn.functional.pad(emit_sorted, (0, pad))
    leaf_start, leaf_count = _leaf_tables(shape, dev)

    out = torch.full((T, tq, cap + 1), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((T, tq), dtype=torch.int64, device=dev)
    ci = 0
    while ci < n_chunks and bool(torch.any(emit_sorted[:, ci * C])):
        leaf_ids = order_t[:, ci * C:(ci + 1) * C]                # (T, C)
        pos, valid = _gather_leaves(leaf_ids, leaf_start, leaf_count,
                                    shape.max_leaf_points)    # (T, C, M)
        rd = metric.rowwise_rdist(qs_t[:, :, None, None, :],
                                  points_perm[pos][:, None])  # (T,tq,C,M)
        lids = leaf_ids[:, None, :].expand(T, tq, C)
        mtake = torch.gather(take_s, 2, lids)                 # (T, tq, C)
        mscan = torch.gather(scan_s, 2, lids)
        accept = valid[:, None] & (mtake[..., None]
                                   | (mscan[..., None]
                                      & (nan_to_inf(rd) < rr)))
        ids = orig_ids[pos].reshape(T, 1, -1)
        cnt = append_ids(out, cnt, accept.reshape(T, tq, -1), ids)
        ci += 1

    inv = _unpermute(qorder, q)
    return (out.reshape(T * tq, cap + 1)[inv, :cap],
            cnt.reshape(T * tq)[inv].to(torch.int32))
