"""Borůvka MST over mutual reachability, the HDBSCAN backbone (the JAX
package's ``trees/boruvka.py``).

The MST of the mutual-reachability graph ``mr(i, j) = max(core_i, core_j,
d(i, j))`` is built in about log₂(n) Borůvka rounds with no dense matrix:
each round finds, for every component, a minimum-weight outgoing edge on
the card, and a host union-find merges the components between rounds.
Two round engines, as in the JAX package:

* ``"scan"`` (the default; "auto" means "scan"): every point's minimum
  outgoing edge by an exact masked scan over all pairs
  (``ops/cuda/mst_kernel.scan_minout``, a hand-written CUDA kernel on the
  card: the JAX package's ``_scan_minout`` is XLA-fused elementwise work
  that plain PyTorch cannot fuse), then one winner per component label
  (``_combine_winners``).  No tree: core distances come from the flat
  index's kernel route on a CUDA f32 corpus of at least
  ``CORE_KNN_MIN_N`` points (capped, with the fold repair) and from a
  plain scan elsewhere.
* ``"dual"`` (a caller knob): tier 1, each point's best other-component
  edge among its k-NN graph neighbours, seeds a per-component threshold
  τ; tier 2, a component-aware leaf-pair sweep in best-first order stops
  where the Euclidean leaf-pair bound exceeds τ.  Plain PyTorch.

**Ties.**  Any cycle among the chosen edges has one weight throughout, so
the union-find skips an edge whose ends are already joined this round; the
total weight is unchanged (the filtered-Borůvka argument).

Each round's wall is recorded in ``last_rounds``: ``round_s``, the engine
on the card through the copy of its winners to the host, and ``host_s``,
the union-find and relabelling.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..distance import Euclidean
from ..ops import bruteforce as bf
from ..ops.cuda.mst_kernel import _rd_unrolled, scan_minout
from ..utils.tree_math import TreeShape
from ..utils.validation import check_points, resolve_device
from .ball_query import _bound_slack, _guarded_centroid_dist, _leaf_tables
from .dual import _join_via_kernel, dual_tree_knn

__all__ = ["boruvka_mst", "mutual_reachability_mst"]

_BIG = 2 ** 31 - 1

#: the least corpus whose core distances take the kernel route
#: (boruvka.py:497)
CORE_KNN_MIN_N = 65536

#: one dict a round of the latest MST: ``round_s``, ``host_s``, ``edges``
last_rounds: list = []


def _kernel_available(pts) -> bool:
    """Whether the core distances may take the kernel route: the points
    lie on a card."""
    return pts.is_cuda


def _sqrt_rn(x):
    """The correctly rounded square root of an f32 tensor on any device
    (through f64, which rounds f32 square roots correctly), as XLA's."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _empty_mst():
    return (np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float64))


# -- the dual engine (boruvka.py:57-284) --------------------------------------

def _boruvka_prep(pts_perm, core_perm, comp, knn_pos, knn_d, lb_eu, *,
                  shape: TreeShape, chunk: int):
    """Round prep (boruvka.py:57-134): tier-1 k-NN-graph candidates,
    component thresholds, leaf summaries, the sweep's visit orders and
    every A-leaf's exact trip count (which replaces the sorted bounds and
    thresholds the JAX sweep tests a step at a time)."""
    n = pts_perm.shape[0]
    LA, MA = shape.n_leaves, shape.max_leaf_points
    dev, wdt = pts_perm.device, pts_perm.dtype
    inf = torch.inf

    # ---- tier 1: k-NN-graph candidates ----
    okk = knn_pos >= 0
    j = knn_pos.clamp_min(0)
    other = okk & (comp[j] != comp[:, None])
    mr = torch.maximum(torch.maximum(core_perm[:, None], core_perm[j]), knn_d)
    mr = torch.where(other & ~torch.isnan(mr), mr, inf)
    sl = torch.argmin(mr, dim=1, keepdim=True)
    bp_w = torch.gather(mr, 1, sl)[:, 0]
    bp_j = torch.where(torch.isfinite(bp_w), torch.gather(j, 1, sl)[:, 0], -1)
    comp_l = comp.long()
    tau_w = torch.full((n,), inf, dtype=wdt, device=dev).scatter_reduce(
        0, comp_l, bp_w, "amin")

    # ---- leaf component summaries + pair skip ----
    leaf_start, leaf_count = _leaf_tables(shape, dev)
    m_ar = torch.arange(MA, device=dev)
    apos = leaf_start[:LA, None] + m_ar                            # (LA, MA)
    a_valid = m_ar < leaf_count[:LA, None]
    apos_s = torch.where(a_valid, apos, 0)
    lcomp = torch.where(a_valid, comp[apos_s], -1)
    lmin = torch.amin(torch.where(a_valid, lcomp, _BIG), dim=1)
    lmax = torch.amax(lcomp, dim=1)
    uniform = lmin == lmax
    skip = (uniform[:, None] & uniform[None, :]
            & (lmax[:, None] == lmax[None, :]))
    eff_lb = torch.where(skip, inf, lb_eu)
    lb_sorted, order = torch.sort(eff_lb, dim=1, stable=True)

    C = max(1, min(chunk, LA))
    pad = -(-LA // C) * C - LA
    if pad:
        order = torch.nn.functional.pad(order, (0, pad), value=LA)
        lb_sorted = torch.nn.functional.pad(lb_sorted, (0, pad), value=inf)

    tau_leaf = torch.amax(torch.where(a_valid, tau_w[comp_l[apos_s]], -inf),
                          dim=1)                                   # (LA,)
    # tau is fixed for the round, so a leaf's best-first scan length is
    # known up front: the columns with lb <= tau, in whole chunks
    m_le = torch.sum(lb_sorted <= tau_leaf[:, None], dim=1)
    trips = -(-m_le // C)

    def pad_a(x, fill):
        # one sentinel leaf (index LA) pads ragged id blocks: tau -inf and
        # no valid members, so it contributes nothing
        return torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    return (bp_w, bp_j, apos_s, a_valid, pad_a(order, LA),
            pad_a(a_valid, False), pad_a(pts_perm[apos_s], 0.0),
            pad_a(torch.where(a_valid, core_perm[apos_s], inf), inf),
            pad_a(lcomp, -1), trips)


def _boruvka_sweep_block(pts_perm, core_perm, comp, order_p, avalid_p,
                         apts_p, acore_p, acomp_p, sw_all, sj_all, ids,
                         steps: int, *, shape: TreeShape, chunk: int):
    """The component-aware leaf-pair sweep for one block of A-leaf ids
    (boruvka.py:137-213), ``steps`` chunk steps: the JAX ``while_loop``
    runs while some leaf of the block has its next bound within tau, which
    is the block's largest trip count (``_boruvka_prep``), so the host
    loop needs no read a step.  Writes the block's rows of ``sw_all`` and
    ``sj_all`` in place."""
    LA, MA = shape.n_leaves, shape.max_leaf_points
    dev, wdt = pts_perm.device, pts_perm.dtype
    leaf_start, leaf_count = _leaf_tables(shape, dev)
    m_ar = torch.arange(MA, device=dev)
    ordx = order_p[ids]
    avx, aptsx, acorex, acompx = (avalid_p[ids], apts_p[ids], acore_p[ids],
                                  acomp_p[ids])
    AB = ids.shape[0]
    C = max(1, min(chunk, LA))

    bw = torch.full((AB, MA), torch.inf, dtype=wdt, device=dev)
    bj = torch.full((AB, MA), -1, dtype=torch.int64, device=dev)
    for ci in range(steps):
        b_ids = ordx[:, ci * C:(ci + 1) * C]
        bpos = leaf_start[b_ids][..., None] + m_ar              # (AB, C, MA)
        bval = m_ar < leaf_count[b_ids][..., None]
        bpos_s = torch.where(bval, bpos, 0)
        bpts = pts_perm[bpos_s]
        bcore = torch.where(bval, core_perm[bpos_s], torch.inf)
        bcomp = torch.where(bval, comp[bpos_s], -2)

        diff = aptsx[:, :, None, None, :] - bpts[:, None]
        d = _sqrt_rn(torch.sum(diff * diff, dim=-1))           # (AB,MA,C,MA)
        w = torch.maximum(torch.maximum(acorex[:, :, None, None],
                                        bcore[:, None]), d)
        othr = ((bcomp[:, None] != acompx[:, :, None, None])
                & bval[:, None] & avx[:, :, None, None])
        w = torch.where(othr & ~torch.isnan(w), w, torch.inf
                        ).reshape(AB, MA, C * MA)
        jj = bpos_s[:, None].expand(AB, MA, C, MA).reshape(AB, MA, C * MA)
        sl = torch.argmin(w, dim=2, keepdim=True)
        cw = torch.gather(w, 2, sl)[..., 0]
        cj = torch.gather(jj, 2, sl)[..., 0]
        better = cw < bw
        bw = torch.where(better, cw, bw)
        bj = torch.where(better, cj, bj)
    sw_all[ids] = bw
    sj_all[ids] = bj


def _boruvka_combine(sw, sj, apos_s, a_valid, bp_w, bp_j, comp):
    """Sweep winners merged with the tier-1 candidates into one candidate
    minimum outgoing edge per component label (boruvka.py:216-245)."""
    n = bp_w.shape[0]
    dev, wdt = bp_w.device, bp_w.dtype
    # leaf-grouped -> per permuted position (each position sits in exactly
    # one leaf slot; invalid slots land on the dropped row n)
    tgt = torch.where(a_valid, apos_s, n).reshape(-1)
    sw_p = torch.full((n + 1,), torch.inf, dtype=wdt, device=dev)
    sw_p[tgt] = sw.reshape(-1)
    sj_p = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    sj_p[tgt] = sj.reshape(-1)
    sw_p, sj_p = sw_p[:n], sj_p[:n]

    use_sweep = sw_p < bp_w
    pt_w = torch.where(use_sweep, sw_p, bp_w)
    pt_j = torch.where(use_sweep, sj_p, bp_j)
    return _winners(pt_w, pt_j, comp, pt_w)


def _winners(pt_w, pt_j, comp, out_w):
    """One winner per component label: scatter-min the point weights onto
    the labels and take the lowest winning point id.  Returns (edge_u,
    edge_v, edge_w) with -1 ids and +inf weight for labels without a live
    component; the weight is ``out_w`` at the winner."""
    n = pt_w.shape[0]
    dev = pt_w.device
    comp_l = comp.long()
    ids = torch.arange(n, device=dev)
    comp_w = torch.full((n,), torch.inf, dtype=pt_w.dtype,
                        device=dev).scatter_reduce(0, comp_l, pt_w, "amin")
    is_win = (pt_w == comp_w[comp_l]) & torch.isfinite(pt_w)
    win_u = torch.full((n,), _BIG, device=dev).scatter_reduce(
        0, comp_l, torch.where(is_win, ids, _BIG), "amin")
    has = win_u < _BIG
    u = torch.where(has, win_u, 0)
    return (torch.where(has, u, -1), torch.where(has, pt_j[u].long(), -1),
            torch.where(has, out_w[u], torch.inf))


def _boruvka_round(pts_perm, core_perm, comp, knn_pos, knn_d, lb_eu, *,
                   shape: TreeShape, chunk: int = 2, ablock: int = 256):
    """One round of the dual engine (boruvka.py:248-284): prep, the sweep
    over blocks of ``ablock`` A-leaves sorted by descending trip count
    (stopping at the first block whose leaves scan nothing), combine."""
    (bp_w, bp_j, apos_s, a_valid, order_p, avalid_p, apts_p, acore_p,
     acomp_p, trips) = _boruvka_prep(
        pts_perm, core_perm, comp, knn_pos, knn_d, lb_eu, shape=shape,
        chunk=chunk)
    LA, MA = shape.n_leaves, shape.max_leaf_points
    dev = pts_perm.device
    trips_np = trips.cpu().numpy()
    by_cost = np.argsort(-trips_np, kind="stable")
    AB = max(1, min(ablock, LA))
    nab = -(-LA // AB)
    ids_pad = np.full(nab * AB, LA, dtype=np.int64)
    ids_pad[:LA] = by_cost
    trips_pad = np.concatenate([trips_np, [0]])
    sw = torch.full((LA + 1, MA), torch.inf, dtype=pts_perm.dtype, device=dev)
    sj = torch.full((LA + 1, MA), -1, dtype=torch.int64, device=dev)
    for b in range(nab):
        ids_b = ids_pad[b * AB:(b + 1) * AB]
        steps = int(trips_pad[ids_b[0]])
        if steps == 0:
            break      # sorted: every remaining leaf scans no chunk
        _boruvka_sweep_block(
            pts_perm, core_perm, comp, order_p, avalid_p, apts_p, acore_p,
            acomp_p, sw, sj, torch.from_numpy(ids_b).to(dev), steps,
            shape=shape, chunk=chunk)
    return _boruvka_combine(sw[:LA], sj[:LA], apos_s, a_valid, bp_w, bp_j,
                            comp)


# -- the scan engine (boruvka.py:301-401) -------------------------------------

def _scan_round(pts, core, comp):
    """One Borůvka round as an exact masked scan (boruvka.py:301-327): for
    every point its minimum outgoing edge in the rd domain,
    ``max(core_i², core_j², ‖x_i − x_j‖²)`` over other-label j
    (``scan_minout``: the kernel on the card), then one winner per label.
    Returns (edge_u, edge_v, edge_w), weights in the distance domain."""
    core_rd = core * core
    pt_w, pt_j = scan_minout(pts, core_rd, comp, pts, core_rd, comp)
    return _combine_winners(pt_w, pt_j, comp)


def _combine_winners(pt_w, pt_j, comp):
    """Per-label winner edge from per-point rd minima (boruvka.py:386-401):
    the lowest-id point at its label's least weight; the weight's square
    root is correctly rounded (``_sqrt_rn``)."""
    return _winners(pt_w, pt_j, comp, _sqrt_rn(pt_w))


# -- core distances (boruvka.py:404-536) --------------------------------------

def _core_scan_block(pts, qs, *, k: int, qchunk: int = 4096,
                     nchunk: int = 16384):
    """(nq,) k-th-nearest-neighbour distance of the ``qs`` rows against
    all of ``pts``, a row of ``pts`` counting itself (the HDBSCAN
    convention), exact, by a dense scan over (qchunk x nchunk) tiles of
    direct-form rd (``_rd_unrolled``) with a running k smallest
    (boruvka.py:405-445: the k-th value of the same multiset)."""
    n = pts.shape[0]
    out = []
    for s in range(0, qs.shape[0], qchunk):
        q = qs[s:s + qchunk]
        best = torch.full((q.shape[0], k), torch.inf, dtype=pts.dtype,
                          device=pts.device)
        for base in range(0, n, nchunk):
            rd = _rd_unrolled(q, pts[base:base + nchunk])
            best = torch.topk(torch.cat([rd, best], dim=1), k, dim=1,
                              largest=False).values
        out.append(torch.amax(best, dim=1))
    return _sqrt_rn(torch.cat(out))


def _core_scan(pts, *, k: int, qchunk: int = 4096, nchunk: int = 16384):
    """``_core_scan_block`` over the whole corpus (boruvka.py:517-536)."""
    return _core_scan_block(pts, pts, k=k, qchunk=qchunk, nchunk=nchunk)


def _core_distances_block(pts, qs, *, k: int, qblock: int = 131072,
                          qchunk: int = 4096, nchunk: int = 16384):
    """Core distances of the ``qs`` rows against the corpus ``pts``
    (boruvka.py:490-514): the kernel route for a CUDA f32 corpus of at
    least ``CORE_KNN_MIN_N`` points and k <= PALLAS_K_MAX
    (``dual._join_via_kernel``: ``knn_prepadded`` with no bcap planes, the
    direct-form rescore and the proof), the dense scan
    (``_core_scan_block``, tiles of ``qchunk`` x ``nchunk``) at k <= 32
    elsewhere, the streamed scan above.  The rule reads only the corpus
    and k, so every row block of one corpus takes the same route.  A
    kernel failure raises (the JAX package falls back to the scan)."""
    n = pts.shape[0]
    if (pts.dtype == torch.float32 and n >= CORE_KNN_MIN_N
            and k <= bf.PALLAS_K_MAX and _kernel_available(pts)):
        # the self-join on the kernel route (boruvka.py:448-487, the JAX
        # _core_knn): capped at 1M points, with the fold repair
        return _join_via_kernel(qs, pts, k, qblock)[0][:, -1]
    if k <= 32:
        return _core_scan_block(pts, qs, k=k, qchunk=qchunk, nchunk=nchunk)
    # large k: the streamed scan (which centres high-dim input itself)
    return torch.cat([bf.knn(pts, qs[s:s + qblock], k,
                             backend="xla")[0][:, -1]
                      for s in range(0, qs.shape[0], qblock)]).to(pts.dtype)


def _core_distances(pts, *, k: int, qblock: int = 131072):
    """Core distances of every point (``_core_distances_block`` over the
    whole corpus)."""
    return _core_distances_block(pts, pts, k=k, qblock=qblock)


# -- the rounds ---------------------------------------------------------------

class _DSU:
    """Small host union-find over component labels."""

    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent
        while p.setdefault(x, x) != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a, b) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def _run_rounds(n: int, round_fn, orig, device):
    """The Borůvka loop (boruvka.py:637-671): rounds on ``device`` and a host
    union-find, until spanning.  ``round_fn(comp)`` gives per-label
    candidate minimum outgoing edges (eu, ev, ew) for the (n,) int32 labels
    ``comp``; ``orig`` maps the engine's point indexing to original ids.
    Returns (us, vs, ws) numpy: int64 ids, float64 weights."""
    global last_rounds
    last_rounds = []
    comp_np = np.arange(n, dtype=np.int32)
    dsu = _DSU()
    us, vs, ws = [], [], []
    for _ in range(2 * int(np.ceil(np.log2(n))) + 2):
        t0 = time.perf_counter()
        eu, ev, ew = (x.cpu().numpy() for x in round_fn(
            torch.from_numpy(comp_np).to(device)))
        t1 = time.perf_counter()
        # the union-find skips tie cycles (weight-neutral: any cycle among
        # per-component minima has one weight)
        merged = 0
        for i in np.flatnonzero(eu >= 0):
            if dsu.union(int(comp_np[eu[i]]), int(comp_np[ev[i]])):
                us.append(int(eu[i]))
                vs.append(int(ev[i]))
                ws.append(float(ew[i]))
                merged += 1
        done = not merged or len(us) >= n - 1
        if not done:
            # relabel on the host: component label -> DSU root
            labels = np.unique(comp_np)
            lut = np.zeros(n, dtype=np.int32)
            lut[labels] = [dsu.find(int(c)) for c in labels]
            comp_np = lut[comp_np]
        last_rounds.append({"round_s": t1 - t0,
                            "host_s": time.perf_counter() - t1,
                            "edges": merged})
        if done:
            break
    if len(us) != n - 1:
        raise RuntimeError(f"Borůvka stopped at {len(us)} of {n - 1} edges")
    return (orig[np.asarray(us, dtype=np.int64)],
            orig[np.asarray(vs, dtype=np.int64)],
            np.asarray(ws, dtype=np.float64))


def boruvka_mst(tree, core, *, knn_width: int = 8, scheme: str = "auto"):
    """Minimum spanning tree of the mutual-reachability graph over a built
    Euclidean ``BallTree`` (boruvka.py:560-634), on the tree's device.
    ``core`` is the (n,) core-distance vector in original point order
    (e.g. the last column of ``dual_tree_knn(tree, tree, k)``).

    ``scheme``: "scan" (the masked scan, no tree bounds), "dual" (the
    k-NN-graph-seeded leaf-pair sweep) or "auto", which is "scan".  Exact
    either way: the total weight equals the dense MST's.  Raises
    ``ValueError`` on NaN points.  Returns (us, vs, ws): n-1 edges in
    original ids, numpy (int64, int64, float64)."""
    if not isinstance(tree.metric, Euclidean):
        raise ValueError("boruvka_mst requires a Euclidean tree")
    if scheme not in ("auto", "scan", "dual"):
        raise ValueError(f"unknown scheme {scheme!r}")
    n = tree.n
    if n < 2:
        return _empty_mst()
    if bool(torch.isnan(tree.points).any()):
        raise ValueError("boruvka_mst requires finite points: a NaN row "
                         "has +inf mutual reachability to everything and "
                         "the MST is undefined")
    if scheme == "auto":
        scheme = "scan"
    dev, dt = tree.device, tree.points.dtype
    core = core if torch.is_tensor(core) else torch.from_numpy(
        np.array(core))
    core_perm = core.to(device=dev, dtype=dt)[tree._orig_ids.long()]
    comp_pts = tree._points_perm

    if scheme == "dual":
        # the Euclidean k-NN graph, rows and ids -> permuted positions
        kd, kid = dual_tree_knn(tree, tree, min(knn_width, n))
        kid = kid.long()
        pos = tree._pos_of_id[kid.clamp_min(0)]
        order = tree._orig_ids.long()
        knn_pos = torch.where(kid >= 0, pos, -1)[order]
        knn_d = kd[order].to(dt)
        # static leaf-pair Euclidean bounds (geometry is round-invariant)
        lc, lr, center = (tree._leaf_centroids, tree._leaf_radii,
                          tree._qcenter)
        lc_c = lc if center is None else lc - center
        d_cc = _guarded_centroid_dist(lc_c, lc_c, tree.metric)
        lb = torch.clamp_min(d_cc - lr[:, None] - lr[None, :], 0.0)
        lb = torch.clamp_min(lb - _bound_slack(dt)
                             * (d_cc + lr[:, None] + lr[None, :]), 0.0)
        lb_eu = torch.where(torch.isnan(lb), 0.0, lb)

        def round_fn(comp):
            return _boruvka_round(comp_pts, core_perm, comp, knn_pos, knn_d,
                                  lb_eu, shape=tree._shape)
    else:
        def round_fn(comp):
            return _scan_round(comp_pts, core_perm, comp)
    return _run_rounds(n, round_fn,
                       tree._orig_ids.cpu().numpy().astype(np.int64), dev)


def mutual_reachability_mst(points, k: int, *, leaf_size: int = 128,
                            knn_width: int = 8, scheme: str = "auto",
                            device=None):
    """End-to-end HDBSCAN MST (boruvka.py:674-724): (us, vs, ws) numpy in
    original ids, n-1 edges (empty arrays for n < 2).  ``k`` is
    min_samples (the point itself counted).

    ``scheme`` "scan" ("auto") builds no tree: core distances from
    ``_core_distances``, the rounds from ``_scan_round``.  "dual" builds a
    ``BallTree`` (``leaf_size``), takes core distances from its k-NN
    (per-query or tiled at d <= 32 and k <= 16, else the self-join) and
    runs ``boruvka_mst(..., scheme="dual")``.  ``device=None`` means
    ``"cuda"``; NaN points raise ``ValueError``."""
    from .ball import BallTree

    if scheme not in ("auto", "scan", "dual"):
        raise ValueError(f"unknown scheme {scheme!r}")
    dev = resolve_device(device)
    pts = check_points(points, dev)
    n, dim = pts.shape
    if n < 2:
        return _empty_mst()
    kk = min(int(k), n)
    if scheme == "auto":
        scheme = "scan"
    if scheme == "scan":
        if bool(torch.isnan(pts).any()):
            raise ValueError(
                "mutual_reachability_mst requires finite points: a NaN row "
                "has +inf mutual reachability to everything and the MST is "
                "undefined")
        core = _core_distances(pts, k=kk)
        return _run_rounds(n, lambda comp: _scan_round(pts, core, comp),
                           np.arange(n, dtype=np.int64), dev)
    tree = BallTree(pts, Euclidean(), leaf_size=leaf_size, device=dev)
    if dim <= 32 and kk <= 16:
        core = torch.cat([tree.query_batch(pts[s:s + 65536], kk)[0][:, -1]
                          for s in range(0, n, 65536)])
    else:
        core = dual_tree_knn(tree, tree, kk)[0][:, -1]
    return boruvka_mst(tree, core, knn_width=max(knn_width, kk),
                       scheme=scheme)
