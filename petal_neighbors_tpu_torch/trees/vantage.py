"""VantagePointTree (the JAX package's ``trees/vantage.py``; parity:
vantage_point_tree.rs).

The build is the reference's (vantage_point_tree.rs:146-197): the vantage
point is the last element of the slice, the rest are sorted by distance
to it, the radius is the median distance (``far[0]``) and singleton leaves
carry the dtype's largest value as radius.  The split is positional, so
the tree is balanced: depth <= ceil(log2 n) + 1, which bounds the radius
search's stack.  Builders: the native C++ one (``native.vp_build``, the
reference's numbering; ``_build_host`` for a metric it has no kind for)
and the level-synchronous one on the index's device
(``vantage_build_device``).

k-NN runs on one of three engines:

* the kernel route: a float32 Euclidean index without NaN rows, n >= 4096
  and k <= 4088 (unless d <= 32 and n > 2,097,152, where the tree's
  pruning wins) takes the flat index's kernels through
  ``ops.bruteforce.knn_prepadded`` (the capped kernel with the fold
  repair at the JAX package's config 2); "auto" takes it on a CUDA
  index;
* the per-query best-first subtree scan (``_vp_knn_flat``): the tree is
  flattened once into a dense trunk and bounded cut subtrees
  (``_flatten_for_query``); the reference's tau pruning ("search near,
  then far only if d + best > radius", :111-129) becomes one lower-bound
  matrix, and each query scans its subtrees in ascending bound order until
  the next bound exceeds its k-th distance;
* the same scan with a frontier shared by tiles of locality-sorted
  queries (``_vp_knn_flat_tiled``).

The JAX package's ``lax.while_loop`` is a host loop here, one
device-to-host read a step (``loop_chunks`` in the stats).  The radius
search is a lockstep DFS with a fixed threshold (``_vp_radius``), its stop
test read every ``RADIUS_CHECK_EVERY`` steps.

``device=None`` means ``"cuda"`` and raises without a card; pass
``device="cpu"`` to run on the CPU, where a forced kernel route runs the
kernels' plain PyTorch versions.  Unlike the JAX package, a kernel failure
raises under "auto" too.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..distance import DIRECT_DIM_MAX, Euclidean, Metric, get_metric
from ..ops import bruteforce as bf
from ..ops.bruteforce import append_ids
from ..ops.cuda.tc_planes import index_planes
from ..ops.topk import merge_topk, nan_to_inf, smallest_k
from ..utils.validation import (check_points, check_query, check_query_batch,
                                resolve_device)
from ._auto import use_device_build
from .ball_build import _np_rowwise_dist
from .ball_query import (_bound_slack, _direct_dist_chunked, _locality_order,
                         _merge_small_k, _pad_chunks, _unpermute)
from .bruteforce import KERNEL_MIN_N

__all__ = ["VantagePointTree"]

NULL = -1  # the reference uses usize::MAX (vantage_point_tree.rs:207)

#: low-dimension corpora above this size stay on the tree engines under
#: "auto": there the tree's pruning wins (vantage.py:740)
KERNEL_LOW_DIM_MAX_N = 2_097_152

#: the radius search reads its stop test every this many steps; steps
#: past the end are no-ops (every row is inactive)
RADIUS_CHECK_EVERY = 16


def _flatten_for_query(vp, radius, near, far, root, *, target: int):
    """Vectorized two-level flattening of the VP tree (host side, once per
    tree): the same output contract as ``_flatten_for_query_reference``,
    with every O(n) step one NumPy operation over one tree level (the tree
    is balanced, so about log2 n levels).

    Trunk numbering and the order of members within a subtree differ from
    the reference walk; neither matters (constraints index trunk slots by
    ``anc_t``, and cut subtrees are scanned as units)."""
    n_nodes = len(vp)
    i32 = np.int32
    vp = np.asarray(vp, dtype=i32)
    near = np.asarray(near, dtype=i32)
    far = np.asarray(far, dtype=i32)

    # parent / which-side links (vectorized scatters)
    parent = np.full(n_nodes, -1, dtype=i32)
    is_near_child = np.zeros(n_nodes, dtype=bool)
    ids = np.arange(n_nodes, dtype=i32)
    m = near >= 0
    parent[near[m]] = ids[m]
    is_near_child[near[m]] = True
    m = far >= 0
    parent[far[m]] = ids[m]

    # levels (root-first); balanced tree -> ~log2 n iterations
    levels = []
    frontier = np.asarray([root], dtype=i32)
    while len(frontier):
        levels.append(frontier)
        kids = np.concatenate([near[frontier], far[frontier]])
        frontier = kids[kids >= 0]

    # subtree sizes: bottom-up, one vector op per level
    size = np.ones(n_nodes, dtype=i32)
    for lvl in reversed(levels):
        size[lvl] = (1 + np.where(near[lvl] >= 0, size[near[lvl]], 0)
                     + np.where(far[lvl] >= 0, size[far[lvl]], 0))

    # trunk = size > target (upward-closed: parents are strictly larger);
    # cut roots = maximal non-trunk subtrees
    trunk_mask = size > target
    is_root = np.zeros(n_nodes, dtype=bool)
    is_root[root] = True
    cut_mask = ~trunk_mask & (is_root | trunk_mask[np.maximum(parent, 0)])
    cut_roots = np.flatnonzero(cut_mask).astype(i32)
    S = len(cut_roots)

    trunk_nodes = np.flatnonzero(trunk_mask)
    t_of = np.zeros(n_nodes, dtype=i32)
    t_of[trunk_nodes] = np.arange(len(trunk_nodes), dtype=i32)
    trunk_pts = vp[trunk_nodes]
    if len(trunk_pts) == 0:          # whole tree fits in one cut subtree
        trunk_pts = np.array([-1], dtype=i32)

    # ancestor constraint chains: walk up one vector step at a time
    # (every ancestor of a cut root is trunk); padding constraints are
    # (t=0, near=True, rho=+inf) -> contrib -inf, a no-op under max
    depth = np.zeros(n_nodes, dtype=i32)
    for d_, lvl in enumerate(levels):
        depth[lvl] = d_
    Dmax = int(depth[cut_roots].max()) if S else 0
    D = max(Dmax, 1)
    anc_t = np.zeros((max(S, 1), D), dtype=i32)
    anc_near = np.ones((max(S, 1), D), dtype=bool)
    anc_rho = np.full((max(S, 1), D), np.inf, dtype=radius.dtype)
    child = cut_roots.copy() if S else np.zeros(0, dtype=i32)
    for j in range(Dmax):
        a = np.where(child >= 0, parent[np.maximum(child, 0)], -1)
        ok = a >= 0
        anc_t[:S, j] = np.where(ok, t_of[np.maximum(a, 0)], 0)
        anc_near[:S, j] = np.where(ok, is_near_child[np.maximum(child, 0)],
                                   True)
        anc_rho[:S, j] = np.where(ok, radius[np.maximum(a, 0)], np.inf)
        child = a

    # member lists: assign every non-trunk node to its cut subtree by
    # top-down propagation (parent resolved before child), then group
    s_of = np.full(n_nodes, -1, dtype=i32)
    s_of[cut_roots] = np.arange(S, dtype=i32)
    cro = s_of.copy()
    for lvl in levels[1:]:
        p = parent[lvl]
        cro[lvl] = np.where(cro[lvl] >= 0, cro[lvl], cro[p])
    sel = np.flatnonzero(cro >= 0).astype(i32)
    g = cro[sel]
    order = np.argsort(g, kind="stable").astype(i32)
    sel, g = sel[order], g[order]
    counts = np.bincount(g, minlength=max(S, 1))
    M = int(counts.max()) if len(sel) else 1
    members = np.full((max(S, 1), max(M, 1)), -1, dtype=i32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = (np.arange(len(sel), dtype=np.int64)
              - np.repeat(starts, counts))
    members[g, within] = vp[sel]
    return trunk_pts, members, anc_t, anc_near, anc_rho


def _flatten_for_query_reference(vp, radius, near, far, root, *,
                                 target: int):
    """Per-node Python reference of the flattening above (the test oracle
    of the vectorized version).

    Splits the tree into a **trunk** (every node whose subtree holds more
    than ``target`` points) and **cut subtrees** (the maximal subtrees of
    at most ``target`` points hanging off the trunk).  Trunk vantage
    points are scored densely; each cut subtree gets a lower bound from
    its trunk ancestors' tau-pruning constraints (vantage_point_tree.rs:
    111-129): a near-side descendant x has d(x, v_a) <= rho_a, so
    d(q, x) >= d(q, v_a) - rho_a; a far-side descendant has d(x, v_a) >=
    rho_a, so d(q, x) >= rho_a - d(q, v_a).

    Returns (trunk_pts (T,), members (S, M) point ids padded -1,
    anc_t (S, D) trunk indices, anc_near (S, D) bool, anc_rho (S, D),
    padded with (0, True, +inf) no-op constraints).
    """
    n_nodes = len(vp)
    size = np.ones(n_nodes, dtype=np.int64)
    order = []
    st = [root]
    while st:
        node = st.pop()
        if node == NULL:
            continue
        order.append(node)
        st.append(near[node])
        st.append(far[node])
    for node in reversed(order):
        s = 1
        if near[node] != NULL:
            s += size[near[node]]
        if far[node] != NULL:
            s += size[far[node]]
        size[node] = s

    trunk = []            # node ids scored densely
    cut_roots = []        # subtree roots scanned as units
    cut_constraints = []  # per cut root: [(trunk_order, near_side, rho)]
    st = [(root, [])]
    while st:
        node, cons = st.pop()
        if node == NULL:
            continue
        if size[node] <= target:
            cut_roots.append(node)
            cut_constraints.append(cons)
        else:
            t = len(trunk)
            trunk.append(node)
            rho = radius[node]
            st.append((far[node], cons + [(t, False, rho)]))
            st.append((near[node], cons + [(t, True, rho)]))

    trunk_pts = np.asarray([vp[t] for t in trunk], dtype=np.int32)
    if len(trunk_pts) == 0:      # whole tree fits in one cut subtree
        trunk_pts = np.array([-1], dtype=np.int32)

    S = len(cut_roots)
    members_lists = []
    for c in cut_roots:
        mem = []
        st2 = [c]
        while st2:
            nd = st2.pop()
            if nd == NULL:
                continue
            mem.append(vp[nd])
            st2.append(near[nd])
            st2.append(far[nd])
        members_lists.append(mem)
    M = max((len(m) for m in members_lists), default=1)
    members = np.full((max(S, 1), M), -1, dtype=np.int32)
    for i, m in enumerate(members_lists):
        members[i, :len(m)] = m

    D = max((len(c) for c in cut_constraints), default=1)
    anc_t = np.zeros((max(S, 1), max(D, 1)), dtype=np.int32)
    anc_near = np.ones((max(S, 1), max(D, 1)), dtype=bool)
    anc_rho = np.full((max(S, 1), max(D, 1)), np.inf, dtype=radius.dtype)
    for i, cons in enumerate(cut_constraints):
        for j, (t, near_side, rho) in enumerate(cons):
            anc_t[i, j] = t
            anc_near[i, j] = near_side
            anc_rho[i, j] = rho
    return trunk_pts, members, anc_t, anc_near, anc_rho


def _trunk_and_bounds(points, queries, trunk_pts, members, anc_t, anc_near,
                      anc_rho, metric: Metric):
    """Both scan engines' first phases (vantage.py:281-304): the trunk's
    direct-form distances (candidates, and the bounds' inputs) and each
    query's tau lower bound to every cut subtree, deflated by a rounding
    slack so that a borderline bound never prunes.  NaN bounds (NaN
    vantage coordinates or radii) never prune: they are 0.  Returns
    (dq (Q, T), candidate distances and ids (Q, T), lb (Q, S))."""
    q = queries.shape[0]
    dq = _direct_dist_chunked(queries, points[trunk_pts.clamp_min(0)],
                              metric, max(1, (1 << 22) // max(q, 1)))
    valid_t = (trunk_pts >= 0)[None, :]
    cand_d = torch.where(valid_t, nan_to_inf(dq), torch.inf)
    cand_i = torch.where(valid_t, trunk_pts[None, :], -1).expand_as(cand_d)

    dq_anc = dq[:, anc_t]                                   # (Q, S, D)
    contrib = torch.where(anc_near[None], dq_anc - anc_rho[None],
                          anc_rho[None] - dq_anc)
    # rho is stored exactly, dq exact to rounding; an infinite rho marks
    # a padding constraint, which takes no slack
    rho_fin = torch.where(torch.isfinite(anc_rho), anc_rho, 0.0)
    contrib = contrib - _bound_slack(points.dtype) * (dq_anc + rho_fin[None])
    lb = torch.clamp_min(torch.amax(contrib, dim=-1), 0.0)  # (Q, S)
    lb = torch.where(torch.isnan(lb), 0.0, lb)
    lb = torch.where(torch.any(members >= 0, dim=1)[None, :], lb, torch.inf)
    return dq, cand_d, cand_i, lb


def _subtree_members(members, sub_ids, S: int):
    """(positions (..., C, M), valid) of the subtrees ``sub_ids`` (..., C),
    the sentinel S and the -1 padding invalid; invalid slots point at
    row 0."""
    pos = members[torch.clamp_max(sub_ids, S - 1)]
    valid = (pos >= 0) & (sub_ids < S)[..., None]
    return torch.where(valid, pos, 0), valid


def _vp_knn_flat(points, queries, trunk_pts, members, anc_t, anc_near,
                 anc_rho, *, k: int, metric: Metric, chunk: int | None = None,
                 with_stats: bool = False):
    """Exact batched k-NN over the flattened VP tree (vantage.py:252-364).

    A best-first chunked subtree scan, as the ball tree's ``knn_query``:
    one bound computation, then a loop over chunks of each query's most
    promising subtrees, stopping when every query's next lower bound
    exceeds its k-th distance.  Exact by the reference's own pruning
    argument: a subtree is skipped only when its tau lower bound exceeds
    the current k-th best; only the visit order differs from the
    recursive original (vantage_point_tree.rs:100-130).

    Every distance is the direct difference form; NaN distances sort as
    farthest.  Returns (distances, ids (int32)), (Q, k) ascending, and with
    ``with_stats`` a dict: n_subtrees, loop_chunks, chunk_size,
    subtrees_surviving_final_bound, prune_ratio, trunk_size."""
    q, dim = queries.shape
    dtype, dev = points.dtype, points.device
    T = trunk_pts.shape[0]
    S, M = members.shape
    _, cand_d, cand_i, lb = _trunk_and_bounds(
        points, queries, trunk_pts, members, anc_t, anc_near, anc_rho, metric)
    best_d = torch.full((q, k), torch.inf, dtype=dtype, device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int64, device=dev)
    best_d, best_i = merge_topk(cand_d, cand_i, best_d, best_i, k)

    lb_sorted, order = torch.sort(lb, dim=1, stable=True)   # best-first
    if chunk is None:
        # keep a chunk's gathered tile (Q, C, M, d) near 32 MB of f32
        chunk = max(1, min((1 << 23) // max(q * M * dim, 1), 4))
    C = max(1, min(chunk, S))
    n_chunks = -(-S // C)
    # the out-of-range sentinel S pads the last chunk: a 0 pad would scan
    # subtree 0 again, and its duplicate ids would crowd out neighbours
    order, lb_sorted = _pad_chunks(order, lb_sorted, S, C)

    ci = 0
    while ci < n_chunks and bool(torch.any(lb_sorted[:, ci * C]
                                           <= best_d[:, -1])):
        pos, valid = _subtree_members(members, order[:, ci * C:(ci + 1) * C],
                                      S)                      # (Q, C, M)
        pts = points[pos]                                     # (Q, C, M, d)
        if isinstance(metric, Euclidean):
            diff = pts - queries[:, None, None, :]
            d = torch.sqrt(torch.sum(diff * diff, dim=-1))
        else:
            d = metric.rowwise_dist(queries[:, None, None, :], pts)
        d = torch.where(valid, nan_to_inf(d), torch.inf).reshape(q, -1)
        ids = torch.where(valid, pos, -1).reshape(q, -1)
        best_d, best_i = merge_topk(d, ids, best_d, best_i, k)
        ci += 1

    best_i = best_i.to(torch.int32)
    if not with_stats:
        return best_d, best_i
    surviving = torch.sum(lb <= best_d[:, -1:], dim=1, dtype=torch.int32)
    stats = {"n_subtrees": S, "loop_chunks": ci, "chunk_size": C,
             "subtrees_surviving_final_bound": surviving,
             "prune_ratio": 1.0 - surviving / S, "trunk_size": T}
    return best_d, best_i, stats


def _vp_knn_flat_tiled(points, queries, trunk_pts, members, anc_t, anc_near,
                       anc_rho, *, k: int, metric: Metric,
                       chunk: int | None = None, tile_q: int = 128,
                       with_stats: bool = False):
    """Exact batched k-NN over the flattened VP tree with a subtree
    frontier shared by tiles of queries (vantage.py:369-496; the ball
    tree's ``knn_query_tiled`` on the cut-subtree scan).

    Queries are sorted by their most promising subtree, and each tile of
    ``tile_q`` shares one visit order, ascending in the tile's least tau
    bound: one (T, C, M, d) gather serves the whole tile.  The loop stops
    when every query's next shared bound exceeds its k-th distance; a
    tile's bound is at most each member's own, so every subtree the
    reference would visit is scanned.  The merge is ``_merge_small_k``,
    for small k.  Returns (distances, ids (int32)) in the caller's query
    order, and with ``with_stats`` a dict: n_subtrees, loop_chunks,
    chunk_size, n_tiles, trunk_size."""
    q, dim = queries.shape
    T = trunk_pts.shape[0]
    S, M = members.shape
    _, cand_d, cand_i, lb = _trunk_and_bounds(
        points, queries, trunk_pts, members, anc_t, anc_near, anc_rho, metric)
    best_d, best_i = smallest_k(cand_d, cand_i, k)

    tq = max(1, min(tile_q, q))
    qorder, Tt = _locality_order(torch.argmin(lb, dim=1), q, tq)
    qs_t = queries[qorder].reshape(Tt, tq, dim)
    lb_tile = torch.amin(lb[qorder].reshape(Tt, tq, S), dim=1)   # (Tt, S)
    best_d = best_d[qorder].reshape(Tt, tq, k)
    best_i = best_i[qorder].reshape(Tt, tq, k)
    lbt_sorted, order_t = torch.sort(lb_tile, dim=1, stable=True)
    if chunk is None:
        # keep the step's distance tensor (Tt, tq, C, M) near 32 MB of f32
        chunk = max(1, min((1 << 23) // max(Tt * tq * M, 1), 8))
    C = max(1, min(chunk, S))
    n_chunks = -(-S // C)
    order_t, lbt_sorted = _pad_chunks(order_t, lbt_sorted, S, C)

    ci = 0
    while ci < n_chunks and bool(torch.any(lbt_sorted[:, ci * C, None]
                                           <= best_d[..., -1])):
        pos, valid = _subtree_members(
            members, order_t[:, ci * C:(ci + 1) * C], S)      # (Tt, C, M)
        pts = points[pos]                                     # (Tt, C, M, d)
        if isinstance(metric, Euclidean):
            diff = pts[:, None] - qs_t[:, :, None, None, :]
            d = torch.sqrt(torch.sum(diff * diff, dim=-1))    # (Tt,tq,C,M)
        else:
            d = metric.rowwise_dist(qs_t[:, :, None, :],
                                    pts.reshape(Tt, 1, -1, dim))
        d = torch.where(valid.reshape(Tt, 1, -1), nan_to_inf(
            d.reshape(Tt, tq, -1)), torch.inf)
        ids = torch.where(valid, pos, -1).reshape(Tt, 1, -1).expand_as(d)
        best_d, best_i = _merge_small_k(d, ids, best_d, best_i, k)
        ci += 1

    inv = _unpermute(qorder, q)
    best_d = best_d.reshape(Tt * tq, k)[inv]
    best_i = best_i.reshape(Tt * tq, k)[inv].to(torch.int32)
    if not with_stats:
        return best_d, best_i
    stats = {"n_subtrees": S, "loop_chunks": ci, "chunk_size": C,
             "n_tiles": Tt, "trunk_size": T}
    return best_d, best_i, stats


def _build_host(points: np.ndarray, metric: Metric):
    """The reference's build on the host in NumPy
    (vantage_point_tree.rs:132-197): an iterative DFS over slices of
    point ids, nodes numbered in the reference's pre-order push order."""
    n = points.shape[0]
    dtype = points.dtype
    fmax = np.finfo(dtype).max

    vp = np.zeros(n, dtype=np.int64)
    radius = np.zeros(n, dtype=dtype)
    near = np.full(n, NULL, dtype=np.int64)
    far = np.full(n, NULL, dtype=np.int64)
    n_nodes = 0

    ids0 = np.arange(n, dtype=np.int64)

    # stack entries: (ids, parent_node, which_child, depth); the parent
    # link is patched once the child id is known (:192-195)
    root = -1
    depth_max = 0
    stack = [(ids0, -1, "root", 0)]
    while stack:
        ids, parent, slot, depth = stack.pop()
        depth_max = max(depth_max, depth)
        if len(ids) == 0:
            node = NULL
        else:
            node = n_nodes
            n_nodes += 1
            if len(ids) == 1:
                vp[node] = ids[0]
                radius[node] = fmax          # leaf radius = MAX (:158-167)
            else:
                v = ids[-1]                  # vantage = last (:169-170)
                rest = ids[:-1]
                d = _np_rowwise_dist(
                    metric, points[rest],
                    np.broadcast_to(points[v], (len(rest), points.shape[1])))
                order = np.argsort(d, kind="stable")  # NaN sorts last
                rest = rest[order]
                d = d[order]
                half = len(rest) // 2
                vp[node] = v
                radius[node] = d[half]       # median = far[0] (:180-182)
                # push far first so near is built (and numbered) first, as
                # the reference recurses (:192-193)
                stack.append((rest[half:], node, "far", depth + 1))
                stack.append((rest[:half], node, "near", depth + 1))
        if slot == "root":
            root = node
        elif slot == "near":
            near[parent] = node
        else:
            far[parent] = node

    return (vp[:n_nodes], radius[:n_nodes], near[:n_nodes], far[:n_nodes],
            root, depth_max)


def _vp_radius(points, vp, radius, near, far, root: int, queries, r, *,
               depth: int, metric: Metric, cap: int):
    """Tree-pruned batched radius search, inclusive ``d <= r``
    (vantage.py:561-631).

    A lockstep DFS with a fixed threshold: by the triangle inequality the
    near subtree is skipped when d(q, vp) - r > rho, the far one when
    d(q, vp) + r < rho; a NaN distance or radius gives no bound, and both
    are visited.  One step visits one node per query; the stack holds
    ``depth + 4`` entries.  Beyond-cap ids go to the last column of a
    cap + 1 buffer (``append_ids``), which is dropped.  The stop test is
    read every ``RADIUS_CHECK_EVERY`` steps: the steps after every stack
    empties change nothing.

    Returns (ids (Q, cap) int32 in visit order, -1 padded; counts (Q,)
    int32, exact past the cap; the steps run)."""
    q = queries.shape[0]
    dev = points.device
    stack = torch.zeros((q, depth + 4), dtype=torch.int64, device=dev)
    stack[:, 0] = root
    sp = torch.ones((q,), dtype=torch.int64, device=dev)
    rr = torch.as_tensor(r, dtype=points.dtype, device=dev)
    out = torch.full((q, cap + 1), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((q,), dtype=torch.int64, device=dev)

    def push(sp, child, do):
        slot = torch.where(do, sp, 0)[:, None]
        cur = torch.gather(stack, 1, slot)
        stack.scatter_(1, slot, torch.where(do[:, None], child[:, None], cur))
        return torch.where(do, sp + 1, sp)

    steps = 0
    while steps % RADIUS_CHECK_EVERY or bool(torch.any(sp > 0)):
        active = sp > 0
        top = torch.where(active, sp - 1, 0)[:, None]
        node = torch.gather(stack, 1, top)[:, 0]
        sp = torch.where(active, sp - 1, sp)

        v = vp[node]
        rho = radius[node]
        draw = metric.rowwise_dist(queries, points[v])
        dnan = torch.isnan(draw)
        d = nan_to_inf(draw)
        accept = active & (d <= rr)
        cnt = append_ids(out, cnt, accept[:, None], v[:, None])

        nr, fr = near[node], far[node]
        nobound = dnan | torch.isnan(rho)
        push_near = active & (nr != NULL) & ((d - rr <= rho) | nobound)
        push_far = active & (fr != NULL) & ((d + rr >= rho) | nobound)
        sp = push(sp, fr, push_far)
        sp = push(sp, nr, push_near)
        steps += 1
    return out[:, :cap], cnt.to(torch.int32), steps


class VantagePointTree:
    """Exact VP-tree index (vantage_point_tree.rs:13-198)."""

    def __init__(self, points, metric: Metric | str = "euclidean", *,
                 builder: str = "auto", device=None):
        """Build the tree (the reference's ``new``,
        vantage_point_tree.rs:51-72).  Raises ``EmptyArrayError`` /
        ``NotContiguousError`` as the reference, and ``ValueError`` for a
        metric that violates the triangle inequality.

        ``builder``: "auto" (the device build for a CUDA index of at
        least ``_auto.DEVICE_BUILD_MIN_N`` points, else "host"),
        "device" (level-synchronous on the index's device, level-order
        node numbers) or "host" (the native C++ builder with the
        reference's numbering, or ``_build_host`` for a metric it has no
        kind for).  ``device``: where the index lives and queries run;
        None means ``"cuda"``."""
        self.metric = get_metric(metric)
        if not self.metric.tree_compatible:
            raise ValueError(
                f"metric {self.metric.name!r} violates the triangle "
                "inequality, so VP-tree pruning bounds are invalid; "
                "use BruteForce for this metric")
        self.device = resolve_device(device)
        self.points = check_points(points, self.device)
        n = self.points.shape[0]
        self.metric.validate_dim(self.points.shape[1])
        if builder == "auto":
            builder = "device" if use_device_build(n, self.device) else "host"
        if builder == "device":
            from .vantage_build_device import build_device
            built = build_device(self.points, self.metric)
        elif builder == "host":
            host = self.points.cpu().numpy()
            built = (native.vp_build(host, self.metric)
                     if native.native_kind(self.metric) is not None
                     else _build_host(host, self.metric))
        else:
            raise ValueError(f"unknown builder {builder!r}")
        #: the builder that made the tree ("device" or "host"); "auto"
        #: resolved
        self.builder = builder
        self._init_arrays(*built)

    def _init_arrays(self, vp, radius, near, far, root, depth) -> None:
        dev = self.device
        self.root = int(root)
        self.depth = int(depth)
        self._vp = torch.as_tensor(np.asarray(vp), dtype=torch.int64,
                                   device=dev)
        self._radius = torch.as_tensor(np.array(radius),
                                       dtype=self.points.dtype, device=dev)
        self._near = torch.as_tensor(np.asarray(near), dtype=torch.int64,
                                     device=dev)
        self._far = torch.as_tensor(np.asarray(far), dtype=torch.int64,
                                    device=dev)
        #: host copies (the reference's node fields)
        self.nodes = {"vantage_point": np.asarray(vp),
                      "radius": np.asarray(radius), "near": np.asarray(near),
                      "far": np.asarray(far)}
        self._flat = None    # the scan engines' tables (_flat_tables)
        self._kern = None    # the kernel route's tables (_kernel_tables);
        #                      False: NaN rows, the route is closed
        #: steps of the latest capped radius search (``_vp_radius``)
        self.last_radius_steps = None

    @classmethod
    def euclidean(cls, points, **kwargs) -> "VantagePointTree":
        """Convenience constructor (vantage_point_tree.rs:31-37)."""
        return cls(points, Euclidean(), **kwargs)

    @classmethod
    def _from_arrays(cls, points, metric, vp, radius, near, far, root,
                     depth, *, device=None):
        """A tree from its arrays, with no rebuild (the JAX package's
        ``_from_arrays``)."""
        self = cls.__new__(cls)
        self.metric = get_metric(metric)
        self.device = resolve_device(device)
        self.points = check_points(points, self.device)
        lens = {len(np.asarray(a)) for a in (vp, radius, near, far)}
        if len(lens) != 1:
            raise ValueError("vp, radius, near and far differ in length")
        self.builder = None
        self._init_arrays(vp, radius, near, far, root, depth)
        return self

    def save(self, path) -> None:
        """Checkpoint the index to an ``.npz`` (``utils.serialize``)."""
        from ..utils.serialize import save_index
        save_index(self, path)

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    def num_points(self) -> int:
        return self.n

    def _np_dtype(self):
        return np.float64 if self.points.dtype == torch.float64 \
            else np.float32

    def _flat_tables(self):
        """The scan engines' tables (``_flatten_for_query``), made once on
        the host and kept on the device.  The cut-subtree size is big
        enough that the scan tiles are fat, small enough that a chunk
        stays cheap."""
        if self._flat is None:
            target = int(min(max(self.n // 256, 64), 2048))
            self._set_flat(_flatten_for_query(
                self.nodes["vantage_point"], self.nodes["radius"],
                self.nodes["near"], self.nodes["far"], self.root,
                target=target))
        return self._flat

    def _set_flat(self, flat) -> None:
        """Keep the five flat tables (trunk points, members, ancestor
        slots, sides and radii, as NumPy) on the device: the index tables
        as int64, the radii in the points' dtype."""
        trunk, members, anc_t, anc_near, anc_rho = (
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in flat)
        self._flat = (trunk.long(), members.long(), anc_t.long(),
                      anc_near.bool(), anc_rho.to(self.points.dtype))

    def _kernel_tables(self):
        """The kernel route's index tables, made on its first query: the
        centred points padded by ``pad_for_pallas`` and their norms, as
        ``BruteForce`` holds them.  ``False`` when the corpus has a NaN
        row: the kernels never return a NaN point, where the scans return
        it at +inf when k exceeds the finite rows, so NaN corpora stay on
        the scans (vantage.py:695-717).  Beside them the padded points'
        piece planes (``index_planes``: on the card only), which the
        tensor-core kernels read, made here once."""
        if self._kern is None:
            if bool(torch.isnan(self.points).any()):
                self._kern = False
            else:
                mu = bf.center_of(self.points)
                pp, pn = bf.pad_for_pallas(self.points - mu)
                self._kern = (mu, pp, pn, index_planes(pp))
        return self._kern

    def _kernel_route_ok(self, q: int, k_eff: int) -> bool:
        """Whether a batch may ride the flat index's kernels instead of
        the subtree scans (vantage.py:719-743, less its availability
        test): a float32 Euclidean index without NaN rows, n >= 4096 and
        1 <= k <= 4088; not at d <= 32 past 2,097,152 points, where the
        tree's pruning wins.  At high d the tree cannot prune, and the
        kernels serve any size."""
        if not (type(self.metric) is Euclidean
                and self.points.dtype == torch.float32
                and 1 <= k_eff <= bf.PALLAS_K_MAX
                and self.n >= KERNEL_MIN_N):
            return False
        if self.dim <= DIRECT_DIM_MAX and self.n > KERNEL_LOW_DIM_MAX_N:
            return False
        return self._kernel_tables() is not False

    def _auto_kernel(self, q: int, k_eff: int) -> bool:
        """Whether "auto" takes the kernel route: on a CUDA index only; a
        CPU index takes the scans, as the JAX package does on a CPU."""
        return self.device.type == "cuda" and self._kernel_route_ok(q, k_eff)

    # -- the reference's API -------------------------------------------------
    def query_nearest(self, needle):
        """(index, distance) of the nearest point
        (vantage_point_tree.rs:88-98)."""
        qv = check_query(needle, self.dim, self.points.dtype, self.device)
        d, i = self._knn(qv[None, :], 1)
        return int(i[0, 0]), float(d[0, 0])

    # -- extensions ----------------------------------------------------------
    def query(self, needle, k: int):
        """k nearest as numpy (indices, distances), ascending, as
        ``BallTree.query``: k=0 gives empty arrays, k>n gives n."""
        qv = check_query(needle, self.dim, self.points.dtype, self.device)
        k_eff = min(int(k), self.n)
        if k_eff == 0:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=self._np_dtype()))
        d, i = self._knn(qv[None, :], k_eff)
        return i[0].cpu().numpy().astype(np.int64), d[0].cpu().numpy()

    def query_batch(self, queries, k: int, *, with_stats: bool = False,
                    scheme: str = "auto"):
        """Batched k-NN: (distances, ids (int32)), each (Q, min(k, n)),
        ascending.

        ``scheme``: "auto" takes the kernel route (``_kernel_route_ok``) on
        a CUDA index when no stats are asked for; else the tile-shared
        scan for Euclidean at d <= 8, k <= 16 and 2048 to 8191 queries;
        else the per-query scan.  "kernel", "per_query" and "tiled" force
        one; a forced "kernel" runs on either device (the plain versions
        on the CPU) and raises ``ValueError`` where the route is closed.
        ``with_stats=True`` returns a third value, a dict: the scans'
        counts (``loop_chunks``, the loop's steps, each one device-to-host
        read), or ``{"kernel_scheme": ...}`` on the kernel route."""
        qs = check_query_batch(queries, self.dim, self.points.dtype,
                               self.device)
        k_eff = min(int(k), self.n)
        if k_eff == 0:
            empty = (torch.zeros((qs.shape[0], 0), dtype=self.points.dtype,
                                 device=self.device),
                     torch.zeros((qs.shape[0], 0), dtype=torch.int32,
                                 device=self.device))
            return (*empty, {}) if with_stats else empty
        if scheme not in ("auto", "kernel", "per_query", "tiled"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if scheme == "kernel" and not self._kernel_route_ok(qs.shape[0],
                                                            k_eff):
            raise ValueError(
                "scheme='kernel' requires Euclidean f32 data without NaN "
                f"rows, n >= {KERNEL_MIN_N} and k <= {bf.PALLAS_K_MAX}")
        if scheme == "auto":
            if not with_stats and self._auto_kernel(qs.shape[0], k_eff):
                scheme = "kernel"
            else:
                scheme = ("tiled" if (self.dim <= 8 and k_eff <= 16
                                      and 2048 <= qs.shape[0] < 8192
                                      and isinstance(self.metric, Euclidean))
                          else "per_query")
        if scheme == "kernel":
            kernel_scheme = bf.pick_scheme(k_eff, self.n, bcap_planes=False)
            d, i = self._kernel_knn(qs, k_eff, kernel_scheme)
            return (d, i, {"kernel_scheme": kernel_scheme}) if with_stats \
                else (d, i)
        if scheme == "tiled":
            return _vp_knn_flat_tiled(self.points, qs, *self._flat_tables(),
                                      k=k_eff, metric=self.metric,
                                      with_stats=with_stats)
        return self._knn(qs, k_eff, with_stats=with_stats)

    def query_nearest_batch(self, queries):
        d, i = self.query_batch(queries, 1)
        return i[:, 0], d[:, 0]

    def query_radius(self, needle, distance):
        """All indices with d <= distance, as numpy int64 ascending (an
        extension with an inclusive boundary: the VP tree has no reference
        radius semantics to follow), tree-pruned by the triangle
        inequality on the vantage radii."""
        qv = check_query(needle, self.dim, self.points.dtype, self.device)
        ids, cnt = self._radius_capped(qv[None, :], distance, self.n)
        return np.sort(ids[0, :int(cnt[0])].cpu().numpy()).astype(np.int64)

    def query_radius_batch(self, queries, distance, *, cap: int | None = None):
        """Batched radius search, inclusive: a (Q, n) bool mask (the flat
        scan, ``ops.bruteforce.radius_mask``) or, with ``cap``, the
        tree-pruned ``(ids (Q, cap) int32, counts (Q,) int32)``, counts
        exact past the cap.  ``last_radius_steps`` holds the capped
        search's steps."""
        qs = check_query_batch(queries, self.dim, self.points.dtype,
                               self.device)
        if cap is None:
            return bf.radius_mask(self.points, qs, distance, self.metric)
        return self._radius_capped(qs, distance, cap)

    def _radius_capped(self, qs, distance, cap: int):
        ids, cnt, self.last_radius_steps = _vp_radius(
            self.points, self._vp, self._radius, self._near, self._far,
            self.root, qs, distance, depth=self.depth, metric=self.metric,
            cap=cap)
        return ids, cnt

    def _kernel_knn(self, qs, k_eff: int, scheme: str):
        """Batched k-NN through the flat index's kernels, exact by the
        direct-form rescore and the proof (``knn_prepadded``).  The VP
        tree holds no bcap planes, so its route never takes bcap."""
        mu, pp, pn, planes = self._kernel_tables()
        return bf.knn_prepadded(pp, pn, qs, k_eff, self.n, mu, scheme=scheme,
                                planes=planes)

    def _knn(self, qs, k_eff: int, with_stats: bool = False):
        return _vp_knn_flat(self.points, qs, *self._flat_tables(), k=k_eff,
                            metric=self.metric, with_stats=with_stats)
