"""The port's dual-tree k-NN join (``trees/dual.py``) on the CPU, against
the JAX package's ``dual_tree_knn`` on trees carried over with
``balltree_from_jax_arrays`` (the JAX tree's own arrays and centre, so
build arithmetic does not move the join).

Engines.  The JAX thresholds are literals, so each JAX engine is called
directly where the port's reaches it only through patched thresholds: the
leaf-pair sweep (both packages' default at small n), the tile-shared tree
scan (``_join_via_tree``) and the kernel route (``_join_via_kernel``, the
JAX kernels in interpret mode, the port's plain versions of capped and
fold).

Tolerance, as tests/test_torch_ball_tree.py: distances within rtol 1e-6
(f32) or 1e-12 (f64), +inf in the same slots; ids equal except where
distances tie within that tolerance (at the k-th, or between neighbouring
slots).  The kernel route scores on centred copies whose centres the two
packages sum in different orders; its distances agree within rtol 1e-6
after the direct-form rescore all the same."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.distance import get_metric as jax_metric
from petal_neighbors_tpu.ops import bruteforce as jbf
from petal_neighbors_tpu.trees import dual as jdual
from petal_neighbors_tpu_torch.convert import balltree_from_jax_arrays
from petal_neighbors_tpu_torch.trees import dual as tdual

from test_torch_ball_tree import assert_knn_match


def _carry(pts, metric="euclidean", leaf_size=16, **kw):
    jt = jpn.BallTree(pts, jax_metric(metric, **kw), leaf_size=leaf_size)
    arrays = {"points": pts, "centroids": np.asarray(jt.nodes.centroids),
              "radii": np.asarray(jt.nodes.radii), "idx": np.asarray(jt.idx)}
    if jt._qcenter is not None:
        arrays["center"] = np.asarray(jt._qcenter)
    tt = balltree_from_jax_arrays(arrays, metric=tpn.get_metric(metric, **kw),
                                  leaf_size=leaf_size, device="cpu")
    return jt, tt


def _pts(seed, n, d, dtype=np.float32, nan_rows=()):
    pts = np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)
    if n > 40:
        pts[20:23] = pts[19]                   # duplicated rows
    for r in nan_rows:
        pts[r, 0] = np.nan
    return pts


def test_carried_tree_keeps_the_jax_tables():
    pts = _pts(0, 300, 3)
    jt, tt = _carry(pts)
    np.testing.assert_array_equal(tt._orig_ids.numpy(),
                                  np.asarray(jt._orig_ids))
    np.testing.assert_array_equal(tt._pos_of_id.numpy(),
                                  np.asarray(jt._pos_of_id))
    np.testing.assert_array_equal(tt._qcenter.numpy(),
                                  np.asarray(jt._qcenter))
    np.testing.assert_array_equal(tt._leaf_centroids.numpy(),
                                  np.asarray(jt._leaf_centroids))
    np.testing.assert_array_equal(tt._leaf_radii.numpy(),
                                  np.asarray(jt._leaf_radii))
    np.testing.assert_array_equal(tdual._leaf_row_of_pos(tt._shape),
                                  jdual._leaf_row_of_pos(jt._shape))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("na,nb,d,k", [(300, 400, 2, 5), (250, 180, 3, 32),
                                       (120, 500, 5, 7), (90, 150, 48, 4)])
def test_sweep_matches_jax(na, nb, d, k, dtype):
    ja, ta = _carry(_pts(na + d, na, d, dtype))
    jb, tb = _carry(_pts(nb + d + 1, nb, d, dtype))
    tdual.last_sweep = {}
    assert_knn_match(jpn.dual_tree_knn(ja, jb, k),
                     tpn.dual_tree_knn(ta, tb, k), dtype)
    assert tdual.last_sweep["rounds"] >= 1
    assert tdual.last_sweep["steps"] >= tdual.last_sweep["rounds"]


def test_self_join_includes_self():
    jt, tt = _carry(_pts(1, 400, 2))
    d, i = tt.query_tree(tt, 3)
    np.testing.assert_array_equal(i[:, 0].numpy()[:19], np.arange(19))
    np.testing.assert_allclose(d[:, 0].numpy(), 0.0, atol=0)
    assert_knn_match(jt.query_tree(jt, 3), (d, i), np.float32)


@pytest.mark.parametrize("metric,kw", [("manhattan", {}),
                                       ("minkowski", {"p": 3.0})])
def test_sweep_generic_metric_matches_jax(metric, kw):
    ja, ta = _carry(_pts(2, 200, 3), metric, **kw)
    jb, tb = _carry(_pts(3, 260, 3), metric, **kw)
    assert_knn_match(jpn.dual_tree_knn(ja, jb, 6),
                     tpn.dual_tree_knn(ta, tb, 6), np.float32)


def test_tree_engine_matches_jax(monkeypatch):
    ja, ta = _carry(_pts(4, 700, 2))
    jb, tb = _carry(_pts(5, 900, 2))
    calls = []
    real = tdual._join_via_tree
    monkeypatch.setattr(tdual, "JOIN_TREE_MIN_N", 512)
    monkeypatch.setattr(tdual, "_join_via_tree",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tpn.dual_tree_knn(ta, tb, 5)
    assert calls == [1]
    assert_knn_match(jdual._join_via_tree(ja, jb, 5), got, np.float32)
    # and in query blocks
    assert_knn_match(jdual._join_via_tree(ja, jb, 4, qblock=128),
                     tdual._join_via_tree(ta, tb, 4, qblock=128), np.float32)


def test_kernel_engine_matches_jax(monkeypatch):
    a = np.random.default_rng(6).random((300, 8), dtype=np.float32)
    b = np.random.default_rng(7).random((3000, 8), dtype=np.float32)
    ja, ta = _carry(a)
    jb, tb = _carry(b)
    calls = []
    real = tdual._join_via_kernel
    monkeypatch.setattr(tdual, "JOIN_KERNEL_MIN_N", 2048)
    monkeypatch.setattr(tdual, "_kernel_available", lambda tree: True)
    monkeypatch.setattr(tdual, "_join_via_kernel",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(jbf, "FORCE_INTERPRET", True)
    got = tpn.dual_tree_knn(ta, tb, 5)
    assert calls == [1]
    want = jdual._join_via_kernel(ja.points, jb.points, 5)
    assert_knn_match(want, got, np.float32)
    # the sweep gives the same answers
    assert_knn_match(jpn.dual_tree_knn(ja, jb, 5), got, np.float32)


def test_engine_rule_stays_on_the_sweep_off_the_card(monkeypatch):
    _, ta = _carry(_pts(8, 200, 5))
    monkeypatch.setattr(tdual, "JOIN_KERNEL_MIN_N", 1)

    def no_kernel(*a, **kw):
        raise AssertionError("a CPU index took the kernel engine")

    monkeypatch.setattr(tdual, "_join_via_kernel", no_kernel)
    d, i = tpn.dual_tree_knn(ta, ta, 3)
    assert d.shape == (200, 3)


def test_k_edges():
    ja, ta = _carry(_pts(9, 60, 2))
    jb, tb = _carry(_pts(10, 25, 2))
    d, i = tpn.dual_tree_knn(ta, tb, 0)
    assert d.shape == (60, 0) and i.shape == (60, 0)
    assert i.dtype == torch.int32
    got = tpn.dual_tree_knn(ta, tb, 40)                    # k > n_B
    assert got[0].shape == (60, 25)
    assert_knn_match(jpn.dual_tree_knn(ja, jb, 40), got, np.float32)


def test_nan_points_sort_farthest():
    ja, ta = _carry(_pts(11, 80, 2, nan_rows=(3, 50)))
    jb, tb = _carry(_pts(12, 30, 2, nan_rows=(7,)))
    got = tpn.dual_tree_knn(ta, tb, 30)
    d, i = got
    # a finite A point keeps the NaN B point last, at +inf; a NaN A point
    # (rows 3 and 50) is +inf everywhere
    fin = np.ones(80, bool)
    fin[[3, 50]] = False
    assert torch.isinf(d[:, -1]).all() and (i[fin, -1] == 7).all()
    assert torch.isinf(d[~fin]).all()
    assert_knn_match(jpn.dual_tree_knn(ja, jb, 30), got, np.float32)


def test_mismatches_raise():
    _, ta = _carry(_pts(13, 50, 2))
    _, tm = _carry(_pts(13, 50, 2), "manhattan")
    _, t3 = _carry(_pts(14, 50, 3))
    with pytest.raises(ValueError, match="metric"):
        tpn.dual_tree_knn(ta, tm, 2)
    with pytest.raises(ValueError, match="dimension"):
        tpn.dual_tree_knn(ta, t3, 2)
