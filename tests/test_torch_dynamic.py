"""The port's DynamicIndex against the JAX package's, on shared numpy
inputs, on the CPU: one sequence of adds, removes, rebuilds and an
automatic rebuild runs on both, and after every step the k-NN and the
capped radius search agree.

Tolerance, as tests/test_torch_ball_tree.py: distances within rtol 1e-6
(f32) or 1e-12 (f64), ids equal except at ties within it; radius ids and
counts (the overflow signal included) equal except for queries with a
pair within 2 ulp of the radius."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.trees.dynamic import DynamicIndex as JaxDynamic
from petal_neighbors_tpu_torch.convert import dynamic_from_jax_state
from petal_neighbors_tpu_torch.trees.dynamic import DynamicIndex, _pow2_pad

from test_torch_ball_tree import assert_knn_match

RADIUS = 0.45


def _live_rows(idx):
    rows = np.concatenate([idx._base_rows] + idx._delta_rows)
    ids = np.concatenate([idx._base_ids] + idx._delta_ids)
    live = ~np.isin(ids, sorted(idx._tombstones))
    return rows[live], ids[live]


def _exact_rows(idx, qs, r, dtype):
    """Queries with no live pair within 2 ulp of r (Euclidean)."""
    rows, _ = _live_rows(idx)
    rd = ((qs[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    rr = float(r) ** 2
    near = np.abs(np.where(np.isnan(rd), np.inf, rd) - rr) <= 2 * float(
        np.spacing(dtype(rr)))
    return ~near.any(axis=1)


def _assert_same(jidx, tidx, qs, dtype):
    assert tidx.num_points == jidx.num_points
    np.testing.assert_array_equal(tidx._live_ids(), jidx._live_ids())
    for k in (1, 7, jidx.num_points + 3):
        jout = jidx.query_batch(qs, k)
        tout = tidx.query_batch(qs, k)
        assert tout[1].dtype == torch.int32
        assert_knn_match(jout, tout, dtype)
    exact = _exact_rows(tidx, qs, RADIUS, dtype)
    for cap in (2, 16, 200):
        ji, jc = (np.asarray(a) for a in jidx.query_radius_batch(
            qs, RADIUS, cap=cap))
        ti, tc = (a.numpy() for a in tidx.query_radius_batch(
            qs, RADIUS, cap=cap))
        assert ti.shape == ji.shape and ti.dtype == tc.dtype == np.int32
        np.testing.assert_array_equal(ti[exact], ji[exact])
        np.testing.assert_array_equal(tc[exact], jc[exact])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mutation_sequence_matches_jax(dtype):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3)).astype(dtype)
    pts[7] = np.nan                               # a NaN row
    pts[40:43] = pts[39]                          # duplicates
    qs = rng.normal(size=(30, 3)).astype(dtype)
    qs[4] = pts[39]
    jidx = JaxDynamic(pts, leaf_size=16, rebuild_threshold=0.3)
    tidx = DynamicIndex(pts, leaf_size=16, rebuild_threshold=0.3,
                        device="cpu")
    _assert_same(jidx, tidx, qs, dtype)

    new = rng.normal(size=(20, 3)).astype(dtype)
    new[3] = pts[39]                              # a duplicate in the delta
    np.testing.assert_array_equal(tidx.add(new), jidx.add(new))
    _assert_same(jidx, tidx, qs, dtype)

    for ids in ([3, 10, 305, 0, 39], [3, 305], [302]):   # repeats: no-ops
        jidx.remove(ids)
        tidx.remove(ids)
        _assert_same(jidx, tidx, qs, dtype)
    assert tidx._padded_mutation_state()[2].shape == (_pow2_pad(6),)

    jidx.rebuild()
    tidx.rebuild()
    assert tidx._delta_rows == [] and len(tidx._base_ids) == 314
    _assert_same(jidx, tidx, qs, dtype)

    # a load past the threshold rebuilds on its own
    more = rng.normal(size=(100, 3)).astype(dtype)
    jidx.add(more[:40])
    tidx.add(more[:40])
    _assert_same(jidx, tidx, qs, dtype)
    np.testing.assert_array_equal(tidx.add(more[40:]), jidx.add(more[40:]))
    assert jidx._delta_rows == [] and tidx._delta_rows == []
    assert tidx._base.n == jidx._base.n == 414
    _assert_same(jidx, tidx, qs, dtype)
    # one row as a 1-D vector, and the single-query API
    (nid,) = tidx.add(qs[0])
    jidx.add(qs[0])
    assert tidx.query_nearest(qs[0]) == (int(nid), 0.0)
    ti, td = tidx.query(qs[1], 5)
    ji, jd = jidx.query(qs[1], 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_array_equal(tidx.query_radius(qs[1], RADIUS),
                                  jidx.query_radius(qs[1], RADIUS))


def test_tombstones_cannot_crowd_out_candidates():
    """dynamic.py's over-fetch (test_dynamic.py:80-90, :135-148): dead base
    rows closest to the query neither push live delta rows out of the
    k-NN nor live rows out of a capped radius list, and counts stay
    exact."""
    base = np.zeros((8, 2), dtype=np.float32)
    base[:, 0] = np.arange(8)
    for cls, kw in ((JaxDynamic, {}), (DynamicIndex, {"device": "cpu"})):
        idx = cls(base, rebuild_threshold=10.0, **kw)
        (far_id,) = idx.add(np.array([[100.0, 0.0]], dtype=np.float32))
        idx.remove([0])
        got, _ = idx.query(np.zeros(2, np.float32), 8)
        assert set(got.tolist()) == {1, 2, 3, 4, 5, 6, 7, int(far_id)}
    pts = np.zeros((10, 2), dtype=np.float32)
    pts[:, 0] = np.arange(10) * 0.01
    out = []
    for cls, kw in ((JaxDynamic, {}), (DynamicIndex, {"device": "cpu"})):
        idx = cls(pts, rebuild_threshold=10.0, **kw)
        idx.remove([0, 1, 2])
        ids, cnt = idx.query_radius_batch(np.zeros((1, 2), np.float32), 1.0,
                                          cap=7)
        ids, cnt = np.asarray(ids), np.asarray(cnt)
        assert set(ids[0][ids[0] >= 0].tolist()) == {3, 4, 5, 6, 7, 8, 9}
        assert cnt[0] == 7
        # the overflow signal: more live members than the cap
        out.append([np.asarray(a) for a in idx.query_radius_batch(
            np.zeros((1, 2), np.float32), 1.0, cap=4)])
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[1][1][0] > 4


def test_radius_overflow_past_the_fetch_matches_jax():
    """A segment whose count passes even the over-fetched width forces the
    count above the cap, in both packages."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (200, 2)).astype(np.float32)
    jidx = JaxDynamic(pts, leaf_size=8, rebuild_threshold=10.0)
    tidx = DynamicIndex(pts, leaf_size=8, rebuild_threshold=10.0,
                        device="cpu")
    new = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    for idx in (jidx, tidx):
        idx.add(new)
        idx.remove([5, 201])
    qs = pts[:12]
    for cap in (1, 3, 50, 300):
        ji, jc = (np.asarray(a) for a in jidx.query_radius_batch(qs, 0.3,
                                                                 cap=cap))
        ti, tc = (a.numpy() for a in tidx.query_radius_batch(qs, 0.3,
                                                             cap=cap))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc, jc)
        if cap < 50:
            assert (tc > cap).all()


def test_boundary_rules_match_jax():
    """A delta row exactly at r follows the strict leaf-scan rule (out);
    after the rebuild both packages decide it alike
    (test_dynamic.py:176-199)."""
    base = np.random.default_rng(3).standard_normal((40, 4))
    q, r = np.zeros(4), 2.0
    results = []
    for cls, kw in ((JaxDynamic, {}), (DynamicIndex, {"device": "cpu"})):
        d = cls(base, leaf_size=4, rebuild_threshold=10.0, **kw)
        bid = d.add(np.array([2.0, 0.0, 0.0, 0.0]))[0]
        iid = d.add(np.array([1.0, 0.0, 0.0, 0.0]))[0]
        got = d.query_radius(q, r)
        assert iid in got and bid not in got
        d.rebuild()
        results.append((got.tolist(), d.query_radius(q, r).tolist()))
        assert iid in results[-1][1]
    assert results[0] == results[1]


def test_ids_stable_and_dead_rows_dropped():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 1, (100, 2)).astype(np.float32)
    idx = DynamicIndex(pts, rebuild_threshold=10.0, device="cpu")
    new = rng.uniform(0, 1, (6, 2)).astype(np.float32)
    ids = idx.add(new)
    np.testing.assert_array_equal(ids, np.arange(100, 106))
    idx.remove(list(range(50)) + [int(ids[1])])
    idx.rebuild()
    assert len(idx._base_rows) == 55 and idx.num_points == 55
    i, d = idx.query(new[0], 1)
    assert i[0] == ids[0] and d[0] == pytest.approx(0.0, abs=1e-6)
    got, _ = idx.query(pts[0], 55)
    assert not set(got.tolist()) & (set(range(50)) | {int(ids[1])})
    idx.remove([5, 5])                      # already removed: a no-op
    assert idx.num_points == 55
    # ids are never reused after a rebuild
    assert idx.add(new[:1])[0] == 106


def test_errors_match_jax(tmp_path):
    pts = np.random.default_rng(5).uniform(0, 1, (4, 2)).astype(np.float32)
    for cls, kw in ((JaxDynamic, {}), (DynamicIndex, {"device": "cpu"})):
        idx = cls(pts, rebuild_threshold=10.0, **kw)
        with pytest.raises(ValueError):
            idx.remove([0, 1, 2, 3])
        assert idx.num_points == 4                  # unchanged
        with pytest.raises(IndexError):
            idx.remove([99])
        idx.remove([0, 0])                          # one removal
        assert idx.num_points == 3
        with pytest.raises(ValueError):
            cls(np.random.rand(10, 3), jpn.Haversine() if cls is JaxDynamic
                else tpn.Haversine(), leaf_size=4, **kw)
    with pytest.raises(tpn.EmptyArrayError):
        DynamicIndex(np.zeros((0, 2)), device="cpu")
    idx = DynamicIndex(pts, device="cpu")
    idx.save(tmp_path / "x.npz")                    # the serialize slice
    assert tpn.load_index(tmp_path / "x.npz",
                          device="cpu").num_points == idx.num_points
    d, i = idx.query_batch(pts, 0)
    assert d.shape == i.shape == (4, 0)


def test_dynamic_from_jax_state():
    """The JAX index's state, pending mutations included, carried across:
    the same answers, and the same next ids."""
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(150, 3)).astype(np.float32)
    qs = rng.normal(size=(20, 3)).astype(np.float32)
    jidx = JaxDynamic(pts, leaf_size=16, rebuild_threshold=10.0)
    jidx.add(rng.normal(size=(9, 3)).astype(np.float32))
    jidx.remove([2, 151])
    base = jidx._base
    state = {"base_rows": jidx._base_rows, "leaf_size": 16,
             "centroids": np.asarray(base.nodes.centroids),
             "radii": np.asarray(base.nodes.radii),
             "idx": np.asarray(base.idx), "base_ids": jidx._base_ids,
             "delta_rows": np.concatenate(jidx._delta_rows),
             "delta_ids": np.concatenate(jidx._delta_ids),
             "tombstones": np.array(sorted(jidx._tombstones)),
             "next_id": jidx._next_id, "rebuild_threshold": 10.0}
    tidx = dynamic_from_jax_state(state, metric="euclidean", device="cpu")
    np.testing.assert_array_equal(tidx._base.idx, base.idx)
    _assert_same(jidx, tidx, qs, np.float32)
    new = rng.normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_array_equal(tidx.add(new), jidx.add(new))
    _assert_same(jidx, tidx, qs, np.float32)
    with pytest.raises(KeyError):
        dynamic_from_jax_state({"base_rows": pts}, device="cpu")


@pytest.mark.parametrize("offset", [1e3, 1e4])
def test_off_origin_high_dim_matches_jax(offset):
    """d = 64 off the origin, with pending adds and removes: the delta
    scan must centre its rows (the port's knn did not, and the matmul form
    lost the true candidates: recall 0.849 at offset 1e4)."""
    rng = np.random.default_rng(13)
    pts = (rng.normal(size=(2000, 64)) + offset).astype(np.float32)
    qs = (rng.normal(size=(100, 64)) + offset).astype(np.float32)
    jidx = JaxDynamic(pts[:1700])
    tidx = DynamicIndex(pts[:1700], device="cpu")
    np.testing.assert_array_equal(tidx.add(pts[1700:]), jidx.add(pts[1700:]))
    gone = rng.choice(2000, 20, replace=False)
    jidx.remove(gone)
    tidx.remove(gone)
    assert tidx._delta_rows and len(tidx._tombstones) == 20
    k = 5
    tout = tidx.query_batch(qs, k)
    assert_knn_match(jidx.query_batch(qs, k), tout, np.float32)
    rows, ids = _live_rows(tidx)
    rd = ((qs[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    want = ids[np.argsort(rd, axis=1, kind="stable")[:, :k]]
    got = tout[1].numpy()
    assert all(set(a) == set(b) for a, b in zip(got, want))
