"""Sharded exact k-NN, radius search and MST on ``torch.distributed``
(the JAX package's ``parallel/api.py``).

Every scheme returns exact results, equal to the single-device call up
to the order of floating-point reductions: top-k merging is associative,
and padding rows are NaN, so the NaN-is-farthest policy keeps them out of
every result.

One process per rank.  Every rank calls an entry point with the same full
inputs (NumPy arrays, or CPU or CUDA tensors) and the same mesh, moves
only its own shard to its device and gets the full result back, as
tensors on that device.  Every rank takes the same route and chunking:
both depend only on the inputs' shapes, which are the same everywhere.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..distance import Euclidean, Metric
from ..ops import bruteforce as bf
from ..ops.topk import monotone_distances, nan_to_inf, smallest_k
from ..utils.validation import check_points, resolve_device
from ._comm import (all_gather_rows, all_reduce_sum, as_tensor, axis_rank,
                    axis_size, mesh_device, ring_shift, shard_rows)

__all__ = ["init_distributed", "default_mesh", "mesh_shape",
           "knn_query_sharded", "knn_points_sharded", "knn_feature_sharded",
           "knn_ring", "tree_query_sharded", "radius_query_sharded",
           "radius_points_sharded", "mutual_reachability_mst_sharded"]

#: bytes of one (queries, chunk, d / P) difference tile of the feature-
#: sharded scan
FEATURE_TILE_BYTES = 256 << 20


def init_distributed(**kwargs) -> None:
    """Start this process's rank (a thin wrapper over
    ``torch.distributed.init_process_group``, the counterpart of
    ``jax.distributed.initialize``): backend NCCL and torchrun's
    ``env://`` rendezvous unless ``kwargs`` say otherwise.  Call it once
    in each process of ``torchrun --nproc_per_node=N``, then
    ``default_mesh``.  A single process never needs it."""
    kwargs.setdefault("backend", "nccl")
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(**kwargs)


def mesh_shape(n: int, n_axes: int) -> tuple:
    """The mesh's shape over ``n`` ranks: (n,) for one axis, and for two
    ``(a, n // a)`` with ``a`` the largest divisor of n at most ⌊√n⌋
    (api.py:87-98)."""
    if n_axes == 1:
        return (n,)
    if n_axes != 2:
        raise ValueError(f"a mesh has one or two axes, not {n_axes}")
    a = math.isqrt(n)
    while n % a:
        a -= 1
    return (a, n // a)


def default_mesh(n_devices: int | None = None, axis_names=("shards",), *,
                 device=None):
    """A 1-D (or factored 2-D) ``DeviceMesh`` over every rank, with
    ``axis_names`` as its ``mesh_dim_names``.

    ``device=None`` means ``"cuda"``: backend NCCL, one rank a card, this
    rank's card ``LOCAL_RANK`` (or the rank modulo the card count);
    ``device="cpu"`` means gloo.  Without a process group it starts a
    world of one (on a ``HashStore``: no launcher); with one, the group's
    backend must be the device's.  ``n_devices`` (None: the world size)
    must equal the world size, or ``ValueError``: a process group cannot
    leave ranks out, where a JAX mesh may take the first n devices."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"a {dev.type} mesh needs {backend}")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"n_devices={n} but the world has {world} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return init_device_mesh(dev.type, mesh_shape(n, len(axis_names)),
                            mesh_dim_names=tuple(axis_names))


def _empty_knn(q: int, dtype, dev):
    return (torch.zeros((q, 0), dtype=dtype, device=dev),
            torch.zeros((q, 0), dtype=torch.int32, device=dev))


def _flatten_gathered(t, p: int, q: int):
    """(P·Q, w) rows gathered from P ranks -> (Q, P·w), rank by rank."""
    return t.reshape(p, q, -1).transpose(0, 1).reshape(q, -1)


# ---------------------------------------------------------------------------
# scheme 1: query DP — queries sharded, index replicated
# ---------------------------------------------------------------------------

def knn_query_sharded(points, queries, k: int, metric: Metric | None = None,
                      *, mesh, axis: str = "shards", device=None):
    """Queries sharded over ``axis``, points replicated (api.py:115-136):
    each rank answers its own query shard with ``bf.knn`` (the kernel
    route for a CUDA f32 Euclidean corpus at d > 32, n >= 4096), then an
    ``all_gather`` over the axis.  Returns (distances, ids) for every
    query."""
    metric = metric or Euclidean()
    dev = mesh_device(mesh, device)
    pts = as_tensor(points).to(dev)
    qs = as_tensor(queries, pts.dtype)
    k_eff = min(int(k), pts.shape[0])
    if k_eff == 0:
        return _empty_knn(qs.shape[0], pts.dtype, dev)
    q_shard, _ = shard_rows(qs, mesh, axis, dev)
    d, i = bf.knn(pts, q_shard, k_eff, metric)
    nq = qs.shape[0]
    return (all_gather_rows(d, mesh, axis)[:nq],
            all_gather_rows(i, mesh, axis)[:nq])


def tree_query_sharded(tree, queries, k: int, *, mesh, axis: str = "shards",
                       chunk_leaves: int = 4, device=None):
    """Query DP over a replicated ``BallTree`` (api.py:139-175): each rank
    runs the best-first leaf scan (``ball_query.knn_query``) for its own
    query shard, stopping on its own, then an ``all_gather``.  The tree's
    arrays are copied to ``device`` where they lie elsewhere."""
    from ..trees import ball_query

    dev = mesh_device(mesh, device)
    qs = as_tensor(queries, tree.points.dtype)
    k_eff = min(int(k), tree.n)
    if k_eff == 0:
        return _empty_knn(qs.shape[0], tree.points.dtype, dev)
    q_shard, _ = shard_rows(qs, mesh, axis, dev)

    def on(t):
        return None if t is None else t.to(dev)

    d, i = ball_query.knn_query(
        on(tree._points_perm), on(tree._perm_norms), on(tree._orig_ids),
        on(tree._leaf_centroids), on(tree._leaf_radii), q_shard,
        on(tree._qcenter), k=k_eff, shape=tree.shape, metric=tree.metric,
        chunk_leaves=chunk_leaves)
    nq = qs.shape[0]
    return (all_gather_rows(d, mesh, axis)[:nq],
            all_gather_rows(i, mesh, axis)[:nq])


def radius_query_sharded(points, queries, radius,
                         metric: Metric | None = None, *, mesh,
                         axis: str = "shards", cap: int | None = None,
                         inclusive: bool = True, device=None):
    """Query-DP radius search, points replicated (api.py:178-218).

    ``cap=None`` returns per-query neighbour counts (the DBSCAN core
    test); with ``cap``, ``(ids (Q, cap), counts)``: ids ascending, -1
    padded, counts exact past the cap (``compact_mask``'s contract).
    Each rank streams its query shard in the direct form
    (``radius_counts_streaming``, ``radius_capped``), with no (Q, n) mask,
    then an ``all_gather``."""
    metric = metric or Euclidean()
    dev = mesh_device(mesh, device)
    pts = as_tensor(points).to(dev)
    qs = as_tensor(queries, pts.dtype)
    q_shard, _ = shard_rows(qs, mesh, axis, dev)   # NaN queries match nothing
    nq = qs.shape[0]
    if cap is None:
        cnt = bf.radius_counts_streaming(pts, q_shard, radius, metric,
                                         inclusive=inclusive)
        return all_gather_rows(cnt, mesh, axis)[:nq]
    ids, cnt = bf.radius_capped(pts, q_shard, radius, metric, cap=cap,
                                inclusive=inclusive)
    if cap > ids.shape[1]:
        ids = torch.nn.functional.pad(ids, (0, cap - ids.shape[1]), value=-1)
    return (all_gather_rows(ids, mesh, axis)[:nq],
            all_gather_rows(cnt, mesh, axis)[:nq])


# ---------------------------------------------------------------------------
# scheme 2: point sharding — points sharded, queries replicated
# ---------------------------------------------------------------------------

def _global_ids(i, base: int, n: int):
    """A shard's local ids as global ids; -1 for missing slots and for the
    NaN padding past row n, which an +inf tie can select (api.py:252)."""
    return torch.where((i >= 0) & (i + base < n), i + base, -1)


def knn_points_sharded(points, queries, k: int, metric: Metric | None = None,
                       *, mesh, axis: str = "shards", device=None):
    """Points row-sharded over ``axis`` (NaN-padded), queries replicated
    (api.py:225-260): each rank takes the exact top-k of its shard, then
    an ``all_gather`` of the P lists and their exact merge.  A rank holds
    n / P rows of the index: the scheme for indexes larger than one
    card's memory."""
    metric = metric or Euclidean()
    dev = mesh_device(mesh, device)
    pts = as_tensor(points)
    n = pts.shape[0]
    qs = as_tensor(queries, pts.dtype).to(dev)
    k_eff = min(int(k), n)
    if k_eff == 0:
        return _empty_knn(qs.shape[0], pts.dtype, dev)
    shard, base = shard_rows(pts, mesh, axis, dev)
    d, i = bf.knn(shard, qs, min(k_eff, shard.shape[0]), metric)
    p, q = axis_size(mesh, axis), qs.shape[0]
    all_d = _flatten_gathered(all_gather_rows(d, mesh, axis), p, q)
    all_i = _flatten_gathered(all_gather_rows(_global_ids(i, base, n), mesh,
                                              axis), p, q)
    return smallest_k(all_d, all_i, k_eff)


def radius_points_sharded(points, queries, radius,
                          metric: Metric | None = None, *, mesh,
                          axis: str = "shards", cap: int | None = None,
                          inclusive: bool = True, device=None):
    """Points row-sharded radius search (api.py:263-316): each rank
    streams its shard; the counts are summed over the axis (``psum``).
    With ``cap``, the local capped lists (global ids) are gathered and
    the first ``cap`` ids taken in ascending global order: the output
    contract of the single-device ``compact_mask``."""
    metric = metric or Euclidean()
    dev = mesh_device(mesh, device)
    pts = as_tensor(points)
    n = pts.shape[0]
    qs = as_tensor(queries, pts.dtype).to(dev)
    shard, base = shard_rows(pts, mesh, axis, dev)     # NaN rows never match
    if cap is None:
        cnt = bf.radius_counts_streaming(shard, qs, radius, metric,
                                         inclusive=inclusive)
        return all_reduce_sum(cnt, mesh, axis)
    ids_l, cnt = bf.radius_capped(shard, qs, radius, metric, cap=cap,
                                  inclusive=inclusive)
    counts = all_reduce_sum(cnt, mesh, axis)
    gids = torch.where(ids_l >= 0, ids_l + base, n + 1)
    p, q = axis_size(mesh, axis), qs.shape[0]
    flat = _flatten_gathered(all_gather_rows(gids, mesh, axis), p, q)
    ids = torch.sort(flat, dim=1).values[:, :min(cap, flat.shape[1])]
    valid = ((torch.arange(ids.shape[1], device=dev)[None, :]
              < counts[:, None]) & (ids <= n))
    ids = torch.where(valid, ids, -1)
    if cap > ids.shape[1]:
        ids = torch.nn.functional.pad(ids, (0, cap - ids.shape[1]), value=-1)
    return ids, counts


# ---------------------------------------------------------------------------
# scheme 2b: tensor parallelism — the feature axis sharded; partial
# distances summed over the axis
# ---------------------------------------------------------------------------

def knn_feature_sharded(points, queries, k: int,
                        metric: Metric | None = None, *, mesh,
                        axis: str = "shards", chunk: int = 4096,
                        device=None):
    """Points and queries sharded over the feature axis (api.py:324-383):
    each rank sums the squared differences over its feature slice, and an
    ``all_reduce`` completes every pairwise term before a running top-k
    over ``chunk``-row point chunks, for rows too wide for one card.
    Queries go in tiles whose (queries, chunk, d / P) difference stays
    near ``FEATURE_TILE_BYTES``.  Exact (the sum rebuilds the squared
    distance; every rank merges the same values).  Euclidean only:
    another metric raises ``ValueError``."""
    metric = metric or Euclidean()
    if not isinstance(metric, Euclidean):
        raise ValueError("feature sharding requires the Euclidean metric "
                         "(additive over feature slices)")
    dev = mesh_device(mesh, device)
    pts = as_tensor(points)
    qs = as_tensor(queries, pts.dtype)
    n, dim = pts.shape
    nq = qs.shape[0]
    k_eff = min(int(k), n)
    if k_eff == 0:
        return _empty_knn(nq, pts.dtype, dev)
    # zero columns pad d to a multiple of P; they add 0 to every distance
    width = -(-dim // axis_size(mesh, axis))
    lo = axis_rank(mesh, axis) * width

    def my_columns(x):
        part = x[:, lo:lo + width].to(dev)
        return torch.nn.functional.pad(part, (0, width - part.shape[1]))

    pf, qf = my_columns(pts), my_columns(qs)
    c = min(chunk, n)
    step = max(1, FEATURE_TILE_BYTES // (c * width * pf.element_size()))
    out_d, out_i = [], []
    for s in range(0, nq, step):
        qt = qf[s:s + step]
        best_d = torch.full((qt.shape[0], k_eff), torch.inf, dtype=pf.dtype,
                            device=dev)
        best_i = torch.full((qt.shape[0], k_eff), -1, dtype=torch.int32,
                            device=dev)
        for base in range(0, n, c):
            diff = qt[:, None, :] - pf[None, base:base + c, :]
            rd = all_reduce_sum(torch.sum(diff * diff, dim=-1), mesh, axis)
            ids = torch.arange(base, base + rd.shape[1], dtype=torch.int32,
                               device=dev).expand(rd.shape[0], -1)
            best_d, best_i = smallest_k(torch.cat([nan_to_inf(rd), best_d], 1),
                                        torch.cat([ids, best_i], 1), k_eff)
        out_d.append(best_d)
        out_i.append(best_i)
    return (monotone_distances(metric.rdistance_to_distance(
        torch.cat(out_d))), torch.cat(out_i))


# ---------------------------------------------------------------------------
# scheme 3: ring — queries and points sharded; point shards rotate
# ---------------------------------------------------------------------------

def knn_ring(points, queries, k: int, metric: Metric | None = None, *,
             mesh, query_axis: str = "q", point_axis: str = "p",
             device=None):
    """2-D mesh ring search (api.py:390-450): queries sharded over
    ``query_axis``, NaN-padded points over ``point_axis``.  Each of the P
    steps merges the local exact top-k of the resident point shard into a
    running result while the next shard arrives from the previous rank
    (``ring_shift``, posted before the step's k-NN into a second buffer,
    so the transfer overlaps the compute).  The resident shard at step s
    came from ``point_axis`` coordinate (me - s) mod P, which gives its
    global row offset.  After P steps every query has seen every point;
    the results, equal along ``point_axis``, are gathered over
    ``query_axis``."""
    metric = metric or Euclidean()
    dev = mesh_device(mesh, device)
    pts = as_tensor(points)
    n = pts.shape[0]
    qs = as_tensor(queries, pts.dtype)
    nq = qs.shape[0]
    k_eff = min(int(k), n)
    if k_eff == 0:
        return _empty_knn(nq, pts.dtype, dev)
    q_shard, _ = shard_rows(qs, mesh, query_axis, dev)
    cur, _ = shard_rows(pts, mesh, point_axis, dev)
    rows = cur.shape[0]
    p, me = axis_size(mesh, point_axis), axis_rank(mesh, point_axis)
    k_local = min(k_eff, rows)
    best_d = torch.full((q_shard.shape[0], k_eff), torch.inf,
                        dtype=pts.dtype, device=dev)
    best_i = torch.full((q_shard.shape[0], k_eff), -1, dtype=torch.int32,
                        device=dev)
    nxt = torch.empty_like(cur) if p > 1 else None
    for step in range(p):
        # the last step's shard goes nowhere: at P = 1 nothing is sent
        pending = ring_shift(cur, nxt, mesh, point_axis) if step < p - 1 \
            else []
        d, i = bf.knn(cur, q_shard, k_local, metric)
        gi = _global_ids(i, ((me - step) % p) * rows, n)
        best_d, best_i = smallest_k(torch.cat([d, best_d], 1),
                                    torch.cat([gi, best_i], 1), k_eff)
        for req in pending:
            req.wait()
        cur, nxt = nxt, cur
    return (all_gather_rows(best_d, mesh, query_axis)[:nq],
            all_gather_rows(best_i, mesh, query_axis)[:nq])


# ---------------------------------------------------------------------------
# the mutual-reachability MST, query rows sharded
# ---------------------------------------------------------------------------

def mutual_reachability_mst_sharded(points, k: int, *, mesh,
                                    axis: str = "shards",
                                    qchunk: int | None = None,
                                    nchunk: int | None = None,
                                    device=None):
    """HDBSCAN mutual-reachability MST (scan scheme) with the query rows
    sharded over ``axis`` and the corpus replicated (api.py:453-537).

    * Core distances: each rank computes its row block's
      (``boruvka._core_distances_block``: the kernel route for a CUDA f32
      corpus of at least ``CORE_KNN_MIN_N`` points, else the dense scan
      with ``qchunk`` x ``nchunk`` tiles), then an ``all_gather``.
    * Borůvka rounds: each rank finds its rows' minimum outgoing edges
      (``mst_kernel.scan_minout``), the per-point minima are gathered, and
      every rank combines the winners and runs the host union-find
      (``_run_rounds``), which is deterministic, so every rank holds the
      same labels.  Padded rows carry +inf cores and label -1.

    ``n < 2`` gives empty arrays; NaN points raise ``ValueError``.
    Returns (us, vs, ws): n - 1 edges, original point ids, numpy."""
    from ..ops.cuda.mst_kernel import scan_minout
    from ..trees.boruvka import (_combine_winners, _core_distances_block,
                                 _empty_mst, _run_rounds)

    dev = mesh_device(mesh, device)
    pts = check_points(points, dev)
    n = pts.shape[0]
    if n < 2:
        return _empty_mst()
    if bool(torch.isnan(pts).any()):
        raise ValueError(
            "mutual_reachability_mst requires finite points: a NaN row "
            "has +inf mutual reachability to everything and the MST is "
            "undefined")
    kk = min(int(k), n)
    p = axis_size(mesh, axis)
    rows = -(-n // p)
    lo = axis_rank(mesh, axis) * rows
    pad = p * rows - n
    # this rank's query rows, zero rows past n (their results are dropped)
    q = pts[lo:lo + rows]
    q = torch.nn.functional.pad(q, (0, 0, 0, rows - q.shape[0]))
    core = all_gather_rows(_core_distances_block(
        pts, q, k=kk, qchunk=qchunk or 4096, nchunk=nchunk or 16384),
        mesh, axis)[:n]
    core_rd = core * core
    cq = torch.cat([core_rd, torch.full((pad,), torch.inf, dtype=core_rd.dtype,
                                        device=dev)])[lo:lo + rows]

    def round_fn(comp):
        cmp_q = torch.cat([comp, torch.full((pad,), -1, dtype=comp.dtype,
                                            device=dev)])[lo:lo + rows]
        bw, bj = scan_minout(pts, core_rd, comp, q, cq, cmp_q)
        return _combine_winners(all_gather_rows(bw, mesh, axis)[:n],
                                all_gather_rows(bj, mesh, axis)[:n], comp)

    return _run_rounds(n, round_fn, np.arange(n, dtype=np.int64), dev)
