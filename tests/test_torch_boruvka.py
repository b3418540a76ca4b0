"""The port's mutual-reachability MST (``trees/boruvka.py``) on the CPU,
against the JAX package's and against a dense f64 scipy MST.

MSTs are unique only up to swaps of equal-weight edges, so the checks are:
the edges span the points with no cycle, and the sorted weights (the
multiset every MST of the graph shares) and the total agree.  Tolerance:
against the JAX package's MST, sorted weights within 2·(d + 2) f32 ulp
(the two sum the direct-form distances in different orders where XLA fuses
FMAs); against the f64 scipy MST, rtol 1e-5 and atol 1e-6, as the JAX
package's own test (tests/test_boruvka.py).  Core distances: the kernel
route (the self-join ``_join_via_kernel``, the plain versions of capped
and fold here) against the dense scan within 2·d ulp; the large-k
streamed scan against numpy within rtol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.sparse.csgraph import minimum_spanning_tree

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.trees import boruvka as jb
from petal_neighbors_tpu_torch.convert import balltree_from_jax_arrays
from petal_neighbors_tpu_torch.trees import boruvka as tb


def _dense_weights(pts, k):
    x = pts.astype(np.float64)
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    core = np.sort(d, axis=1)[:, k - 1]          # self included
    m = np.maximum(d, np.maximum(core[:, None], core[None, :]))
    np.fill_diagonal(m, 0.0)
    return np.sort(minimum_spanning_tree(m).tocoo().data)


def _check_tree(us, vs, n):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    assert len(us) == n - 1
    for u, v in zip(us, vs):
        ru, rv = find(int(u)), find(int(v))
        assert ru != rv, "cycle in MST output"
        parent[ru] = rv
    assert len({find(i) for i in range(n)}) == 1, "not spanning"


def _close_to_jax(ws, jws, d):
    a, b = np.sort(ws), np.sort(np.asarray(jws))
    tol = 2 * (d + 2) * np.spacing(np.float32(np.maximum(b, 1e-30)))
    assert np.all(np.abs(a - b) <= tol)


def _clusters(rng, n, d):
    centres = rng.normal(scale=6.0, size=(3, d))
    return (centres[rng.integers(0, 3, size=n)]
            + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("scheme", ["scan", "dual"])
@pytest.mark.parametrize("n,d,k", [(300, 2, 5), (250, 5, 4)])
def test_mutual_reachability_mst_matches_jax_and_dense(scheme, n, d, k):
    pts = _clusters(np.random.default_rng(n + d), n, d)
    us, vs, ws = tpn.mutual_reachability_mst(pts, k, scheme=scheme,
                                             leaf_size=16, device="cpu")
    assert us.dtype == np.int64 and ws.dtype == np.float64
    _check_tree(us, vs, n)
    _, _, jws = jb.mutual_reachability_mst(pts, k, scheme=scheme,
                                           leaf_size=16)
    _close_to_jax(ws, jws, d)
    np.testing.assert_allclose(np.sort(ws), _dense_weights(pts, k),
                               rtol=1e-5, atol=1e-6)
    assert abs(ws.sum() - float(np.sum(jws))) <= 1e-6 * ws.sum()


def test_auto_is_scan_and_records_rounds():
    pts = np.random.default_rng(1).standard_normal((200, 3)).astype(
        np.float32)
    a = tpn.mutual_reachability_mst(pts, 4, device="cpu")
    rounds = list(tb.last_rounds)
    b = tpn.mutual_reachability_mst(pts, 4, scheme="scan", device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert 1 <= len(rounds) <= 2 * int(np.ceil(np.log2(200))) + 2
    assert sum(r["edges"] for r in rounds) == 199
    assert all(r["round_s"] >= 0 and r["host_s"] >= 0 for r in rounds)


def test_heavy_ties_duplicates():
    # every point three times: mutual-reachability plateaus, the regime
    # where an inconsistent tie-break would close cycles
    base = np.random.default_rng(2).standard_normal((50, 2))
    pts = np.concatenate([base, base, base]).astype(np.float32)
    for scheme in ("scan", "dual"):
        us, vs, ws = tpn.mutual_reachability_mst(pts, 4, scheme=scheme,
                                                 leaf_size=8, device="cpu")
        _check_tree(us, vs, len(pts))
        np.testing.assert_allclose(np.sort(ws), _dense_weights(pts, 4),
                                   rtol=1e-5, atol=1e-6)


def _jax_tree(pts, leaf_size):
    jt = jpn.BallTree.euclidean(pts, leaf_size=leaf_size)
    tt = balltree_from_jax_arrays(
        {"points": pts, "centroids": np.asarray(jt.nodes.centroids),
         "radii": np.asarray(jt.nodes.radii), "idx": np.asarray(jt.idx)},
        leaf_size=leaf_size, device="cpu")
    return jt, tt


@pytest.mark.parametrize("scheme", ["scan", "dual"])
def test_boruvka_mst_on_a_carried_tree_matches_jax(scheme):
    pts = _clusters(np.random.default_rng(3), 240, 3)
    jt, tt = _jax_tree(pts, 16)
    d, _ = jpn.dual_tree_knn(jt, jt, 5)
    core = np.asarray(d)[:, -1]
    us, vs, ws = tpn.boruvka_mst(tt, core, scheme=scheme)
    _check_tree(us, vs, 240)
    _, _, jws = jb.boruvka_mst(jt, core, scheme=scheme)
    _close_to_jax(ws, jws, 3)


def test_core_distances_kernel_route_matches_scan(monkeypatch):
    pts = torch.from_numpy(np.random.default_rng(4).random(
        (700, 6), dtype=np.float32))
    calls = []
    real = tb._join_via_kernel

    def spy(queries, points, k, qblock=131072):
        calls.append(k)
        return real(queries, points, k, qblock=256)

    monkeypatch.setattr(tb, "_kernel_available", lambda p: True)
    monkeypatch.setattr(tb, "CORE_KNN_MIN_N", 512)
    monkeypatch.setattr(tb, "_join_via_kernel", spy)
    got = tb._core_distances(pts, k=5)
    assert calls == [5]
    want = tb._core_scan(pts, k=5)
    tol = 2 * 6 * np.spacing(want.numpy())
    assert np.all(np.abs(got.numpy() - want.numpy()) <= tol)
    # the JAX package's dense scan agrees too
    jw = np.asarray(jb._core_scan(jnp.asarray(pts.numpy()), k=5))
    assert np.all(np.abs(want.numpy() - jw) <= tol)


def test_core_distances_stay_on_the_scan_off_the_card(monkeypatch):
    pts = torch.from_numpy(np.random.default_rng(5).random(
        (300, 4), dtype=np.float32))
    monkeypatch.setattr(tb, "CORE_KNN_MIN_N", 1)

    def no_kernel(*a, **k):
        raise AssertionError("a CPU corpus took the kernel route")

    monkeypatch.setattr(tb, "_join_via_kernel", no_kernel)
    np.testing.assert_array_equal(tb._core_distances(pts, k=3).numpy(),
                                  tb._core_scan(pts, k=3).numpy())


@pytest.mark.parametrize("d", [8, 40])
def test_core_distances_large_k_matches_numpy(d):
    pts = np.random.default_rng(6).standard_normal((300, d)).astype(
        np.float32)
    x = pts.astype(np.float64)
    dist = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    for k in (40, 64):
        got = tb._core_distances(torch.from_numpy(pts), k=k, qblock=128)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.sort(dist, axis=1)[:, k - 1],
                                   rtol=1e-5, atol=1e-6)


def test_core_scan_matches_jax_with_ragged_tiles():
    pts = np.random.default_rng(7).integers(-6, 7, size=(333, 5)).astype(
        np.float32)
    for k in (1, 4, 7):
        got = tb._core_scan(torch.from_numpy(pts), k=k, qchunk=64,
                            nchunk=128)
        want = np.asarray(jb._core_scan(jnp.asarray(pts), k=k, qchunk=64,
                                        nchunk=128))
        np.testing.assert_array_equal(got.numpy(), want)


def test_nan_rows_raise():
    pts = np.random.default_rng(8).standard_normal((50, 2)).astype(
        np.float32)
    pts[3] = np.nan
    with pytest.raises(ValueError, match="finite"):
        tpn.mutual_reachability_mst(pts, 3, device="cpu")
    tree = tpn.BallTree.euclidean(pts, device="cpu")
    d, _ = tpn.dual_tree_knn(tree, tree, 3)
    with pytest.raises(ValueError, match="finite"):
        tpn.boruvka_mst(tree, d[:, -1])


def test_small_n_and_bad_arguments():
    one = np.zeros((1, 3), np.float32)
    for out in (tpn.mutual_reachability_mst(one, 3, device="cpu"),
                tpn.boruvka_mst(tpn.BallTree.euclidean(one, device="cpu"),
                                np.zeros(1, np.float32))):
        assert [a.shape for a in out] == [(0,), (0,), (0,)]
        assert [a.dtype for a in out] == [np.int64, np.int64, np.float64]
    for n, leaf in [(2, 128), (3, 1), (17, 4)]:
        pts = np.random.default_rng(n).standard_normal((n, 2)).astype(
            np.float32)
        for scheme in ("scan", "dual"):
            us, vs, _ = tpn.mutual_reachability_mst(
                pts, min(3, n), leaf_size=leaf, scheme=scheme, device="cpu")
            _check_tree(us, vs, n)
    pts = np.zeros((5, 2), np.float32)
    with pytest.raises(ValueError, match="scheme"):
        tpn.mutual_reachability_mst(pts, 2, scheme="prim", device="cpu")
    with pytest.raises(ValueError, match="Euclidean"):
        tpn.boruvka_mst(tpn.BallTree(pts, "manhattan", device="cpu"),
                        np.zeros(5, np.float32))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((10, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpn.mutual_reachability_mst(pts, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpn.hdbscan(pts, 3)


def test_float64_points_run_in_float64():
    pts = _clusters(np.random.default_rng(9), 120, 2).astype(np.float64)
    us, vs, ws = tpn.mutual_reachability_mst(pts, 4, device="cpu")
    _check_tree(us, vs, 120)
    np.testing.assert_allclose(np.sort(ws), _dense_weights(pts, 4),
                               rtol=1e-12, atol=1e-12)
