"""The port's BallTree queries against the JAX package's BallTree, on
shared numpy inputs, on the CPU.

Tolerance: distances within rtol 1e-6 (f32) or 1e-12 (f64), +inf in the
same slots; ids equal, except where distances tie within that tolerance:
at the k-th (the visit order may keep either id), and between two
neighbouring slots (another summation order may swap them, so there the
ids below the k-th are equal as sets).  Radius
masks, counts and id lists are equal, except for pairs whose f64 reduced
distance lies within 2 ulp of the reduced radius.

The tiled k-NN scheme at d > 32 (taken only when forced: "auto" takes it
at d <= 32) scores in the uncentred product form with no rescore, as the
JAX package's does; there the squared distances agree within that form's
rounding bound, 8·d·eps·(‖q‖² + max ‖x‖²), and ids away from ties within
it."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.distance import get_metric as jax_metric
from petal_neighbors_tpu_torch.convert import balltree_from_jax_arrays
from petal_neighbors_tpu_torch.distance import get_metric as port_metric

METRICS = {"euclidean": ("euclidean", {}), "manhattan": ("manhattan", {}),
           "minkowski3": ("minkowski", {"p": 3.0})}
STATS_KEYS = {"per_query": {"n_leaves", "loop_chunks", "chunk_leaves",
                            "leaves_surviving_final_bound", "prune_ratio"},
              "tiled": {"n_leaves", "loop_chunks", "chunk_leaves",
                        "n_tiles"}}


def _trees(pts, name, leaf_size=16, builder="vectorized"):
    metric, kw = METRICS[name]
    return (jpn.BallTree(pts, jax_metric(metric, **kw), leaf_size=leaf_size,
                         builder=builder),
            tpn.BallTree(pts, port_metric(metric, **kw), leaf_size=leaf_size,
                         builder=builder, device="cpu"))


def _data(n, d, dtype, q, seed=0):
    rng = np.random.default_rng(seed + 11 * n + d)
    pts = rng.normal(size=(n, d)).astype(dtype)
    qs = rng.normal(size=(q, d)).astype(dtype)
    pts[[4, 17], 0] = np.nan                   # NaN rows
    pts[30:34] = pts[29]                       # duplicated rows
    qs[2, -1] = np.nan                         # a NaN query
    qs[3] = pts[29]                            # a query on the duplicates
    return pts, qs


def _rtol(dtype):
    return 1e-6 if dtype == np.float32 else 1e-12


def assert_knn_match(jout, tout, dtype, rd_atol=None):
    """``rd_atol``: compare squared distances within it (the product
    form's bound) instead of distances within the relative tolerance."""
    jd, ji = (np.asarray(a) for a in jout[:2])
    td, ti = tout[0].numpy(), tout[1].numpy()
    assert td.shape == jd.shape and ti.shape == ji.shape
    assert td.dtype == dtype and ti.dtype == np.int32
    np.testing.assert_array_equal(np.isposinf(td), np.isposinf(jd))
    fin = np.isfinite(jd)
    if rd_atol is None:
        np.testing.assert_allclose(td[fin], jd[fin], rtol=_rtol(dtype),
                                   atol=_rtol(dtype))
    else:
        np.testing.assert_allclose(td[fin] ** 2, jd[fin] ** 2, rtol=0,
                                   atol=rd_atol)
    if jd.shape[1] == 0:
        return
    def ties(a, b):
        with np.errstate(invalid="ignore"):          # inf - inf
            close = (np.isclose(a, b, rtol=_rtol(dtype), atol=0)
                     if rd_atol is None
                     else np.abs(a ** 2 - b ** 2) <= 2 * rd_atol)
        return close | (np.isposinf(a) & np.isposinf(b))
    at_kth = ties(jd, jd[:, -1:])
    nxt = ties(jd[:, 1:], jd[:, :-1])
    swapped = np.zeros_like(at_kth)
    swapped[:, 1:] |= nxt
    swapped[:, :-1] |= nxt
    off = (ti != ji) & ~at_kth & ~swapped
    assert not off.any(), np.argwhere(off)[:5]
    for r in np.flatnonzero(((ti != ji) & ~at_kth).any(axis=1)):
        assert set(ti[r][~at_kth[r]]) == set(ji[r][~at_kth[r]]), r


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(METRICS))
@pytest.mark.parametrize("d", [2, 5, 40])
def test_knn_matches_jax(d, name, dtype):
    n = 300
    pts, qs = _data(n, d, dtype, q=520 if d == 2 else 40)
    jt, tt = _trees(pts, name)
    np.testing.assert_array_equal(tt.idx, jt.idx)
    for k in (0, 1, 2, 10, n + 5):
        for scheme in ("per_query", "tiled", "auto"):
            if scheme == "tiled" and (k > 16 or d > 32):
                # the k-pass merge is for small k; d > 32: below
                continue
            jout = jt.query_batch(qs, k, scheme=scheme)
            tout = tt.query_batch(qs, k, scheme=scheme)
            assert_knn_match(jout, tout, dtype)
            # a NaN query is at +inf from every point (the tree, as the
            # JAX package's, returns real ids there)
            assert np.isposinf(tout[0][2].numpy()).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forced_tiled_at_high_dim_matches_jax(dtype):
    pts, qs = _data(300, 40, dtype, q=40)
    jt, tt = _trees(pts, "euclidean")
    fin = ~np.isnan(pts).any(axis=1)
    norms = (pts[fin].astype(np.float64) ** 2).sum(1).max() + np.nanmax(
        (qs.astype(np.float64) ** 2).sum(1))
    rd_atol = 8 * 40 * np.finfo(dtype).eps * norms
    for k in (1, 2, 10):
        assert_knn_match(jt.query_batch(qs, k, scheme="tiled"),
                         tt.query_batch(qs, k, scheme="tiled"), dtype,
                         rd_atol=rd_atol)


@pytest.mark.parametrize("scheme,d", [("per_query", 3), ("per_query", 40),
                                      ("tiled", 3)])
def test_with_stats_keys_and_counts(d, scheme):
    pts, qs = _data(400, d, np.float32, q=64, seed=3)
    jt, tt = _trees(pts, "euclidean")
    jd, ji, js = jt.query_batch(qs, 5, scheme=scheme, with_stats=True)
    td, ti, ts = tt.query_batch(qs, 5, scheme=scheme, with_stats=True)
    assert set(ts) == set(js) == STATS_KEYS[scheme]
    assert_knn_match((jd, ji), (td, ti), np.float32)
    for key in ("n_leaves", "chunk_leaves", "loop_chunks", "n_tiles"):
        if key in js:
            assert int(ts[key]) == int(js[key]), key
    if scheme == "per_query":
        np.testing.assert_array_equal(
            ts["leaves_surviving_final_bound"].numpy(),
            np.asarray(js["leaves_surviving_final_bound"]))
        np.testing.assert_allclose(ts["prune_ratio"].numpy(),
                                   np.asarray(js["prune_ratio"]), rtol=1e-6)
    # the same results as the call without stats
    np.testing.assert_array_equal(tt.query_batch(qs, 5, scheme=scheme)[1],
                                  ti)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_edge_sizes_match_jax(dtype):
    rng = np.random.default_rng(9)
    one = rng.normal(size=(1, 3)).astype(dtype)
    qs = rng.normal(size=(6, 3)).astype(dtype)
    for leaf in (None, 16):
        jt = jpn.BallTree.euclidean(one, leaf_size=leaf)
        tt = tpn.BallTree.euclidean(one, leaf_size=leaf, device="cpu")
        for k in (0, 1, 4):
            for scheme in ("per_query", "tiled"):
                assert_knn_match(jt.query_batch(qs, k, scheme=scheme),
                                 tt.query_batch(qs, k, scheme=scheme), dtype)
    pts, qs = _data(90, 4, dtype, q=20, seed=1)
    jt, tt = _trees(pts, "euclidean", leaf_size=None)
    for k in (1, 3, 95):
        assert_knn_match(jt.query_batch(qs, k), tt.query_batch(qs, k), dtype)
    # all points identical: zero-radius balls; k above n on both schemes
    same = np.ones((12, 2), dtype)
    jt, tt = _trees(same, "euclidean", leaf_size=None)
    for k in (3, 15):
        for scheme in ("per_query", "tiled"):
            assert_knn_match(jt.query_batch(qs[:, :2], k, scheme=scheme),
                             tt.query_batch(qs[:, :2], k, scheme=scheme),
                             dtype)


@pytest.mark.parametrize("builder", ["device", "reference"])
def test_other_builders_answer_as_jax(builder):
    pts, qs = _data(250, 3, np.float64, q=30, seed=2)
    jt, tt = _trees(pts, "euclidean", leaf_size=8, builder=builder)
    np.testing.assert_array_equal(tt.idx, jt.idx)
    assert_knn_match(jt.query_batch(qs, 7), tt.query_batch(qs, 7),
                     np.float64)


def test_single_query_api_matches_jax():
    pts, qs = _data(200, 3, np.float64, q=5, seed=4)
    jt, tt = _trees(pts, "euclidean")
    q = qs[0]
    assert tt.query_nearest(q)[0] == jt.query_nearest(q)[0]
    assert tt.query_nearest(q)[1] == pytest.approx(jt.query_nearest(q)[1],
                                                   rel=1e-12)
    ti, td = tt.query(q, 6)
    ji, jd = jt.query(q, 6)
    assert ti.dtype == np.int64 and isinstance(td, np.ndarray)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-12)
    i0, d0 = tt.query(q, 0)
    assert i0.shape == d0.shape == (0,)
    assert len(tt.query(q, 500)[0]) == 200
    np.testing.assert_array_equal(tt.query_nearest_batch(qs)[0].numpy(),
                                  np.asarray(jt.query_nearest_batch(qs)[0]))


# ---- radius ---------------------------------------------------------------

def _rd64(pts, qs):
    d = ((qs[:, None, :].astype(np.float64) - pts[None].astype(np.float64))
         ** 2).sum(-1)
    return np.where(np.isnan(d), np.inf, d)


def _near(pts, qs, r, dtype):
    rr = float(r) ** 2
    return np.abs(_rd64(pts, qs) - rr) <= 2.0 * float(np.spacing(dtype(rr)))


class TestReferenceRadiusCases:
    """The reference's own cases (the JAX package's test_ball_tree.py:
    149-200) on the port."""

    def test_1d_grid(self):
        """ball_tree_query_radius (ball_tree.rs:767-782)."""
        pts = np.array([[0.0], [2.0], [3.0], [4.0], [6.0], [8.0], [10.0]])
        for leaf in (None, 4, 128):
            t = tpn.BallTree.euclidean(pts, leaf_size=leaf, device="cpu")
            assert t.query_radius(np.array([0.1]), 1.0).tolist() == [0]
            assert t.query_radius(np.array([3.2]), 1.0).tolist() == [2, 3]
            assert t.query_radius(np.array([9.0]), 0.9).size == 0

    def test_boundary_take_vs_scan(self):
        """A point at exactly distance r is in by the whole-subtree take
        (ub <= r) and out by the leaf scan (strict d < r),
        ball_tree.rs:271-277."""
        pts = np.array([[1.0], [1.5], [9.0]])
        t = tpn.BallTree.euclidean(pts, leaf_size=None, device="cpu")
        j = jpn.BallTree.euclidean(pts, leaf_size=None)
        for q, r, want in (([0.5], 1.0, [0]), ([5.25], 3.75, [1, 2])):
            assert t.query_radius(np.array(q), r).tolist() == want
            assert sorted(j.query_radius(np.array(q), r).tolist()) == want
            ids, cnt = t.query_radius_batch(np.array([q]), r, cap=3,
                                            scheme="per_query")
            assert sorted(ids[0, :int(cnt[0])].tolist()) == want
            ids, cnt = t.query_radius_batch(np.array([q]), r, cap=3,
                                            scheme="tiled")
            assert sorted(ids[0, :int(cnt[0])].tolist()) == want
            assert t.query_radius_count_batch(np.array([q]), r).tolist() == [
                len(want)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,d", [("euclidean", 2), ("euclidean", 5),
                                    ("manhattan", 3), ("minkowski3", 2)])
def test_radius_matches_jax(name, d, dtype):
    pts, qs = _data(300, d, dtype, q=512 if d == 2 else 60, seed=5)
    jt, tt = _trees(pts, name, leaf_size=8)
    near = _near(pts, qs, 0.5, dtype) if name == "euclidean" else \
        np.zeros((len(qs), len(pts)), bool)
    exact = ~near.any(axis=1)
    for r in (0.2, 0.5):
        jm = np.asarray(jt.query_radius_batch(qs, r))
        tm = tt.query_radius_batch(qs, r).numpy()
        assert tm.dtype == bool and tm.any() and not tm[:, [4, 17]].any()
        assert not ((jm != tm) & ~near).any()
        tc = tt.query_radius_count_batch(qs, r).numpy()
        np.testing.assert_array_equal(tc, tm.sum(axis=1))
        np.testing.assert_array_equal(
            tc[exact], np.asarray(jt.query_radius_count_batch(qs, r))[exact])
        for scheme, cap in (("per_query", 3), ("per_query", 64),
                            ("tiled", 3), ("tiled", 64), ("auto", 64)):
            ji, jc = (np.asarray(a) for a in jt.query_radius_batch(
                qs, r, cap=cap, scheme=scheme))
            ti, tcnt = (a.numpy() for a in tt.query_radius_batch(
                qs, r, cap=cap, scheme=scheme))
            assert ti.dtype == tcnt.dtype == np.int32
            np.testing.assert_array_equal(tcnt, tc)
            np.testing.assert_array_equal(ti[exact], ji[exact])
            np.testing.assert_array_equal(tcnt[exact], jc[exact])
            if cap == 3:
                assert (tcnt > cap).any()    # counts past the cap
            for row in np.flatnonzero(tcnt <= cap):
                assert sorted(ti[row, :tcnt[row]].tolist()) == \
                    np.flatnonzero(tm[row]).tolist()


def test_radius_cosine_and_nan_query():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(200, 4))
    qs = rng.normal(size=(10, 4))
    qs[0, 0] = np.nan
    jt = jpn.BallTree(pts, jpn.Cosine(), leaf_size=8)
    tt = tpn.BallTree(pts, tpn.Cosine(), leaf_size=8, device="cpu")
    jm = np.asarray(jt.query_radius_batch(qs, 0.1))
    tm = tt.query_radius_batch(qs, 0.1).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert not tm[0].any()
    assert_knn_match(jt.query_batch(qs, 4), tt.query_batch(qs, 4),
                     np.float64)


# ---- carry-over, accessors -------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_balltree_from_jax_arrays(dtype):
    pts, qs = _data(400, 3, dtype, q=40, seed=6)
    jt = jpn.BallTree.euclidean(pts, leaf_size=16)
    arrays = {"points": pts, "centroids": np.asarray(jt.nodes.centroids),
              "radii": np.asarray(jt.nodes.radii), "idx": np.asarray(jt.idx)}
    tt = balltree_from_jax_arrays(arrays, metric="euclidean", leaf_size=16,
                                  device="cpu")
    np.testing.assert_array_equal(tt.idx, jt.idx)
    np.testing.assert_array_equal(tt.nodes.radii.numpy(),
                                  np.asarray(jt.nodes.radii))
    for k in (1, 5):
        for scheme in ("per_query", "tiled"):
            assert_knn_match(jt.query_batch(qs, k, scheme=scheme),
                             tt.query_batch(qs, k, scheme=scheme), dtype)
    near = _near(pts, qs, 0.3, dtype)
    jm = np.asarray(jt.query_radius_batch(qs, 0.3))
    tm = tt.query_radius_batch(qs, 0.3).numpy()
    assert not ((jm != tm) & ~near).any()
    ji, jc = jt.query_radius_batch(qs, 0.3, cap=8)
    ti, tc = tt.query_radius_batch(qs, 0.3, cap=8)
    exact = ~near.any(axis=1)
    np.testing.assert_array_equal(ti.numpy()[exact], np.asarray(ji)[exact])
    np.testing.assert_array_equal(tc.numpy()[exact], np.asarray(jc)[exact])
    with pytest.raises(KeyError):
        balltree_from_jax_arrays({"points": pts}, leaf_size=16, device="cpu")
    with pytest.raises(ValueError):
        balltree_from_jax_arrays(arrays, leaf_size=4, device="cpu")


def test_node_accessors_match_jax():
    rng = np.random.default_rng(10)
    pts = rng.uniform(0, 1, (20, 3))
    jt = jpn.BallTree.euclidean(pts, leaf_size=None)
    tt = tpn.BallTree.euclidean(pts, leaf_size=None, device="cpu")
    assert tt.num_nodes() == jt.num_nodes() == len(tt.nodes)
    assert tt.num_points() == 20 and tt.n == 20 and tt.dim == 3
    for n1 in range(tt.num_nodes()):
        assert tt.children_of(n1) == jt.children_of(n1)
        np.testing.assert_array_equal(tt.points_of(n1), jt.points_of(n1))
        assert tt.radius_of(n1) == pytest.approx(jt.radius_of(n1), rel=1e-12)
        node, jnode = tt.nodes[n1], jt.nodes[n1]
        assert node.range == jnode.range and node.is_leaf == jnode.is_leaf
        np.testing.assert_allclose(node.centroid, jnode.centroid, atol=1e-12)
        for n2 in (0, 1, 2, tt.num_nodes() - 1):
            assert tt.node_distance_lower_bound(n1, n2) == pytest.approx(
                jt.node_distance_lower_bound(n1, n2), abs=1e-12)
            assert tt.compare_nodes(n1, n2) == jt.compare_nodes(n1, n2)
    with pytest.raises(IndexError):
        tt.node_distance_lower_bound(0, 10 ** 6)
    with pytest.raises(IndexError):
        tt.nodes[10 ** 6]


def test_later_slices_and_errors(tmp_path):
    pts = np.random.default_rng(0).normal(size=(30, 2))
    tt = tpn.BallTree.euclidean(pts, device="cpu")
    tt.save(tmp_path / "x.npz")                     # the serialize slice
    np.testing.assert_array_equal(
        tpn.load_index(tmp_path / "x.npz", device="cpu").idx, tt.idx)
    # the dual-tree join is carried since the join slice: the self-join
    # keeps each point first, at 0
    d, i = tt.query_tree(tt, 2)
    assert d.shape == i.shape == (30, 2)
    assert (i[:, 0].numpy() == np.arange(30)).all() and (d[:, 0] == 0).all()
    with pytest.raises(ValueError, match="scheme"):
        tt.query_batch(pts, 2, scheme="nope")
    with pytest.raises(ValueError, match="scheme"):
        tt.query_radius_batch(pts, 0.1, cap=2, scheme="nope")
    with pytest.raises(ValueError):
        tt.query_batch(np.zeros((2, 3)), 1)
    with pytest.raises(ValueError):
        tt.query(np.zeros(3), 1)
    assert tt.query_batch(pts, 0, with_stats=True)[2] == {}
    assert tt.points.device == torch.device("cpu")
