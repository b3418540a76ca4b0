"""Start a world of ranks on this host and check every sharded scheme in it
(the counterpart of ``__graft_entry__.dryrun_multichip``).

    python3 -m petal_neighbors_tpu_torch.parallel.dryrun 4 cpu

``run_ranks`` spawns one process a rank, joined through a ``file://``
rendezvous in a temporary directory, each process group with a 60-second
timeout, so that a rank that hangs fails its collectives instead of
holding the others; the whole run has its own deadline.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils.validation import resolve_device

__all__ = ["run_ranks", "dryrun_multichip"]

#: a collective that waits longer than this fails in its rank
GROUP_TIMEOUT_S = 60


def _rank_main(rank: int, fn, n: int, rendezvous: str, device_type: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"file://{rendezvous}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, args: tuple = (), *, device=None,
              timeout: float = 600.0) -> None:
    """Run ``fn(*args)`` in each of ``n`` new processes, ranks 0 to n - 1
    of one world: NCCL with rank r on card r (``device=None``, which
    needs n cards) or gloo (``device="cpu"``).  ``fn`` must be importable
    by name (the processes are spawned).  Raises what a rank raised, or
    ``TimeoutError`` after ``timeout`` seconds; every process has ended
    when it returns."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} ranks on NCCL need {n} cards, found "
                               f"{torch.cuda.device_count()}")
        # the ranks load the kernels at first use: built here once, n
        # builds at a time stay out of the collectives' timeout
        from ..ops.cuda import _build
        _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, os.path.join(tmp, "rendezvous"),
                              dev.type, tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks ran past {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_rank(n: int, device_type: str) -> None:
    """One rank of the dryrun: every scheme on one full sharded step,
    cross-checked against this rank's single-device calls with the JAX
    dryrun's tolerances (__graft_entry__.py:118-200)."""
    from ..ops import bruteforce as bf
    from ..trees import BallTree, DynamicIndex, mutual_reachability_mst
    from . import api
    from ._comm import all_gather_rows, shard_rows

    mesh_dev = None if device_type == "cuda" else "cpu"
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(64 * n, 16)).astype(np.float32)
    qs = rng.normal(size=(8 * n, 16)).astype(np.float32)
    k, r = 5, 1.5

    # 2-D mesh: query DP axis x point-shard ring axis
    mesh2d = api.default_mesh(n, ("q", "p"), device=mesh_dev)
    d_ring, _ = api.knn_ring(pts, qs, k, mesh=mesh2d)
    # 1-D mesh: point sharding, the tree, feature sharding, radius
    mesh1d = api.default_mesh(n, ("shards",), device=mesh_dev)
    dev = d_ring.device
    p_dev, q_dev = torch.from_numpy(pts).to(dev), torch.from_numpy(qs).to(dev)
    d_ps, _ = api.knn_points_sharded(pts, qs, k, mesh=mesh1d)
    tree = BallTree.euclidean(pts, leaf_size=16, device=dev)
    d_tree, _ = api.tree_query_sharded(tree, qs, k, mesh=mesh1d)
    d_tp, _ = api.knn_feature_sharded(pts, qs, k, mesh=mesh1d)
    cnt_dp = api.radius_query_sharded(pts, qs, r, mesh=mesh1d)
    _, cnt_ps = api.radius_points_sharded(pts, qs, r, mesh=mesh1d, cap=16)
    cnt_ref = bf.radius_counts(bf.radius_mask(p_dev, q_dev, r))
    _check(torch.equal(cnt_dp, cnt_ref), "radius query-DP counts != "
           "single-device")
    _check(torch.equal(cnt_ps, cnt_ref), "radius points-sharded counts != "
           "single-device")

    # DynamicIndex under query DP: queries sharded, index replicated
    dyn = DynamicIndex(pts, leaf_size=16, rebuild_threshold=10.0, device=dev)
    dyn.add(rng.normal(size=(24, 16)).astype(np.float32))
    dyn.remove([1, len(pts) + 3])
    q_shard, _ = shard_rows(q_dev, mesh1d, "shards", dev)
    d_dyn = all_gather_rows(dyn.query_batch(q_shard, k)[0], mesh1d,
                            "shards")[:len(qs)]
    cnt_dyn = all_gather_rows(dyn.query_radius_batch(q_shard, r, cap=16)[1],
                              mesh1d, "shards")[:len(qs)]
    _check(torch.allclose(d_dyn, dyn.query_batch(q_dev, k)[0], rtol=1e-5),
           "sharded DynamicIndex k-NN != single-device")
    _check(torch.equal(cnt_dyn, dyn.query_radius_batch(q_dev, r, cap=16)[1]),
           "sharded DynamicIndex radius != single-device")

    # the sharded HDBSCAN MST against the single-device scan
    _, _, ws_mesh = api.mutual_reachability_mst_sharded(pts, 5, mesh=mesh1d)
    _, _, ws_one = mutual_reachability_mst(pts, 5, scheme="scan",
                                           device=dev)
    _check(np.allclose(np.sort(ws_mesh), np.sort(ws_one), rtol=1e-6),
           "sharded MST weights != single-device")

    d_ref, _ = bf.knn(p_dev, q_dev, k)
    for name, d in (("ring", d_ring), ("points-sharded", d_ps),
                    ("sharded-tree", d_tree), ("feature-sharded", d_tp)):
        _check(torch.allclose(d, d_ref, rtol=1e-5),
               f"{name} result != single-device result")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n}, {device_type}): ring + points-sharded "
              "+ sharded-tree + feature-sharded exact k-NN + sharded radius "
              "+ query-DP DynamicIndex + sharded Borůvka MST OK on mesh "
              f"{tuple(mesh2d.shape)}", flush=True)


def dryrun_multichip(n: int, *, device=None) -> None:
    """Start ``n`` ranks and run one full sharded step of every scheme:
    the ring on a 2-D mesh, point sharding, the replicated ball tree,
    feature sharding, both radius forms, ``DynamicIndex`` under query
    sharding and the MST, each cross-checked against single-rank calls;
    raises on a mismatch.  ``device=None`` runs NCCL and needs ``n``
    cards; ``device="cpu"`` runs gloo."""
    dev = resolve_device(device)
    run_ranks(_dryrun_rank, n, (n, dev.type), device=dev)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     device=sys.argv[2] if len(sys.argv) > 2 else None)
