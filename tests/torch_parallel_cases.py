"""The cases of ``test_torch_parallel.py`` as the port's ranks run them.

This module imports neither jax nor the JAX package: the ranks are
spawned processes that import it by name.  ``make_inputs`` makes every
case's inputs from the JAX tests' seed (``tests/test_parallel.py``, whose
``rng`` fixture is ``default_rng(42)`` anew for each test), in the same
order of draws, so both packages see the same arrays.  ``run_all`` is one
rank of the 8-rank gloo world; ``world_of_one`` runs in a process with no
process group, where ``default_mesh`` starts a world of one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from petal_neighbors_tpu_torch import (BallTree, Cosine,
                                       mutual_reachability_mst)
from petal_neighbors_tpu_torch.convert import balltree_from_jax_arrays
from petal_neighbors_tpu_torch.ops import bruteforce as bf
from petal_neighbors_tpu_torch.parallel import api

#: the k of each k-NN case
K = {"query": 5, "points": 7, "points_k_gt_shard": 20, "ring": 6,
     "ring_nan_padding": 10, "ring_all_nan_shard": 9, "tree": 6,
     "tree_cosine": 4, "feature": 6, "mst_weights": 5, "mst_spanning": 3}
#: radius, cap and inclusive of each radius case
RADIUS = {"radius_query_counts": (1.1, None),
          "radius_query_capped": (1.1, 64),
          "radius_points_counts": (1.1, None),
          "radius_points_capped": (1.1, 64),
          "radius_points_cap_spans_shards": (4.0, 200),
          "radius_query_cap_above_n": (4.0, 64),
          "radius_points_cap_above_n": (4.0, 64)}
LEAF_SIZE = 16


def _rng():
    return np.random.default_rng(42)


def _radius_data(rng, n=700, dim=5, q=37):
    pts = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((q, dim)).astype(np.float32)
    return pts, qs


def make_inputs() -> dict:
    """Every case's arrays, keyed ``"<case>.<array>"``."""
    out = {}

    def put(case, pts, qs=None):
        out[f"{case}.pts"] = pts
        if qs is not None:
            out[f"{case}.qs"] = qs

    def uniform(case, n, q, d):
        rng = _rng()
        put(case, rng.uniform(0, 1, (n, d)), rng.uniform(0, 1, (q, d)))

    uniform("query", 300, 41, 6)          # 41 queries: not divisible by 8
    uniform("points", 301, 17, 4)         # ragged shards
    uniform("points_k_gt_shard", 40, 4, 3)
    uniform("ring", 222, 33, 5)
    uniform("ring_nan_padding", 10, 5, 2)  # 10 -> 12 rows over 4 shards
    uniform("ring_all_nan_shard", 9, 5, 2)  # the 4th shard is all NaN
    uniform("tree", 400, 29, 3)
    rng = _rng()
    put("tree_cosine", rng.standard_normal((160, 5)),
        rng.standard_normal((13, 5)))
    uniform("feature", 200, 12, 19)       # ragged dim
    uniform("feature_non_euclidean", 10, 2, 4)
    for case, n in (("radius_query_counts", 700),
                    ("radius_query_capped", 700),
                    ("radius_points_counts", 701),
                    ("radius_points_capped", 701),
                    ("radius_points_cap_spans_shards", 640),
                    ("radius_query_cap_above_n", 40),
                    ("radius_points_cap_above_n", 41)):
        put(case, *_radius_data(_rng(), n=n))
    pts, qs = _radius_data(_rng())
    qs[2] = np.nan                        # a NaN query: empty result
    pts[5] = qs[0]                        # exactly on the boundary at r=0
    put("radius_nan_query_and_strict_boundary", pts, qs)
    put("mst_weights", _rng().normal(size=(333, 8)))
    put("mst_spanning", _rng().uniform(0, 1, (64, 4)))
    pts = _rng().normal(size=(32, 4))
    pts[3, 1] = np.nan
    put("mst_nan", pts)
    return out


def _tree(data, case):
    arrays = {key: data[f"{case}.{key}"]
              for key in ("pts", "centroids", "radii", "idx", "center")
              if f"{case}.{key}" in data}
    arrays["points"] = arrays.pop("pts")
    metric = Cosine() if case == "tree_cosine" else "euclidean"
    return balltree_from_jax_arrays(arrays, metric=metric,
                                    leaf_size=LEAF_SIZE, device="cpu")


def _raises(fn, match=""):
    try:
        fn()
    except ValueError as err:
        return np.int64(match in str(err))
    return np.int64(0)


def _np(out):
    return tuple(t.numpy() if torch.is_tensor(t) else np.asarray(t)
                 for t in out)


def _run_case(case, data, mesh1, mesh2):
    """One case's outputs (a tuple of numpy arrays) on this rank."""
    pts, qs = data[f"{case}.pts"], data.get(f"{case}.qs")
    if case in ("query",):
        return _np(api.knn_query_sharded(pts, qs, K[case], mesh=mesh1))
    if case.startswith("points"):
        return _np(api.knn_points_sharded(pts, qs, K[case], mesh=mesh1))
    if case.startswith("ring"):
        return _np(api.knn_ring(pts, qs, K[case], mesh=mesh2))
    if case.startswith("tree"):
        return _np(api.tree_query_sharded(_tree(data, case), qs, K[case],
                                          mesh=mesh1))
    if case == "feature":
        return _np(api.knn_feature_sharded(pts, qs, K[case], mesh=mesh1))
    if case == "feature_non_euclidean":
        return (_raises(lambda: api.knn_feature_sharded(
            pts, qs, 2, Cosine(), mesh=mesh1)),)
    if case == "radius_nan_query_and_strict_boundary":
        return _np([api.radius_query_sharded(pts, qs, 0.0, mesh=mesh1,
                                             inclusive=inclusive)
                    for inclusive in (True, False)])
    if case.startswith("radius"):
        r, cap = RADIUS[case]
        run = (api.radius_query_sharded if case.startswith("radius_query")
               else api.radius_points_sharded)
        out = run(pts, qs, r, mesh=mesh1, cap=cap)
        return _np(out if isinstance(out, tuple) else (out,))
    if case == "mst_nan":
        return (_raises(lambda: api.mutual_reachability_mst_sharded(
            pts, 3, mesh=mesh1), "finite"),)
    return _np(api.mutual_reachability_mst_sharded(pts, K[case], mesh=mesh1))


CASES = ("query", "points", "points_k_gt_shard", "ring", "ring_nan_padding",
         "ring_all_nan_shard", "tree", "tree_cosine", "feature",
         "feature_non_euclidean", *RADIUS,
         "radius_nan_query_and_strict_boundary", "mst_weights",
         "mst_spanning", "mst_nan")


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        for x, y in zip(a, b))


def run_all(in_path: str, out_path: str) -> None:
    """One rank of the 8-rank world: every case on the 1-D (8,) and the
    2-D (2, 4) mesh.  Rank 0 writes each case's outputs
    (``"<case>.<i>"``), whether every rank got the same outputs
    (``"<case>.agree"``), and the world's set-up checks."""
    torch.set_num_threads(1)
    data = dict(np.load(in_path))
    mesh1 = api.default_mesh(8, ("shards",), device="cpu")
    mesh2 = api.default_mesh(8, ("q", "p"), device="cpu")
    res = {"world.size": np.int64(dist.get_world_size()),
           "world.mesh1": np.asarray(mesh1.shape),
           "world.mesh2": np.asarray(mesh2.shape),
           "world.n_devices_mismatch_raises": _raises(
               lambda: api.default_mesh(4, device="cpu"), "world")}
    outs = {case: _run_case(case, data, mesh1, mesh2) for case in CASES}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, outs)
    if dist.get_rank() == 0:
        for case, out in outs.items():
            res[f"{case}.agree"] = np.int64(all(_same(out, other[case])
                                                for other in every))
            res.update({f"{case}.{i}": a for i, a in enumerate(out)})
        np.savez(out_path, **res)


def world_of_one(in_path: str, out_path: str) -> None:
    """Every entry point with no process group (``default_mesh`` starts a
    world of one on a ``HashStore``) against the single-device port call,
    bit for bit: writes one flag a check."""
    torch.set_num_threads(1)
    data = dict(np.load(in_path))
    mesh1 = api.default_mesh(device="cpu")
    mesh2 = api.default_mesh(axis_names=("q", "p"), device="cpu")
    res = {"meshes": np.int64(tuple(mesh1.shape) == (1,)
                              and tuple(mesh2.shape) == (1, 1)
                              and dist.get_world_size() == 1),
           "n_devices_mismatch_raises": _raises(
               lambda: api.default_mesh(2, device="cpu"), "world")}

    def same(a, b):
        return np.int64(_same(_np(a), _np(b)))

    pts, qs = (torch.from_numpy(data[f"query.{key}"]) for key in ("pts", "qs"))
    want = bf.knn(pts, qs, 5)
    res["knn_query_sharded"] = same(
        api.knn_query_sharded(pts.numpy(), qs.numpy(), 5, mesh=mesh1), want)
    res["knn_points_sharded"] = same(
        api.knn_points_sharded(pts, qs, 5, mesh=mesh1), want)
    res["knn_ring"] = same(api.knn_ring(pts, qs, 5, mesh=mesh2), want)
    res["knn_feature_sharded"] = same(
        api.knn_feature_sharded(pts, qs, 5, mesh=mesh1), want)
    tree = BallTree.euclidean(pts, leaf_size=LEAF_SIZE, device="cpu")
    res["tree_query_sharded"] = same(
        api.tree_query_sharded(tree, qs, 5, mesh=mesh1),
        tree.query_batch(qs, 5, scheme="per_query"))
    pts, qs = (torch.from_numpy(data[f"radius_query_capped.{key}"])
               for key in ("pts", "qs"))
    counts = bf.radius_counts_streaming(pts, qs, 1.1)
    capped = bf.radius_capped(pts, qs, 1.1, cap=64)
    for name, run in (("radius_query_sharded", api.radius_query_sharded),
                      ("radius_points_sharded", api.radius_points_sharded)):
        res[name] = np.int64(
            same((run(pts, qs, 1.1, mesh=mesh1),), (counts,))
            and same(run(pts, qs, 1.1, mesh=mesh1, cap=64), capped))
    pts = data["mst_weights.pts"]
    res["mutual_reachability_mst_sharded"] = same(
        api.mutual_reachability_mst_sharded(pts, 5, mesh=mesh1),
        mutual_reachability_mst(pts, 5, device="cpu"))
    dist.destroy_process_group()
    np.savez(out_path, **res)
