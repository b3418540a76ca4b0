"""The port's VantagePointTree against the JAX package's, on shared numpy
inputs, on the CPU.

Query tolerance, as tests/test_torch_ball_tree.py: distances within rtol
1e-6 (f32) or 1e-12 (f64), +inf in the same slots; ids equal except where
distances tie within that tolerance.  The kernel route scores on centred
copies whose centres the two packages sum in different orders; there the
distances agree within 4·eps·(max |x| + max |q|) and ids away from ties
within it.  Radius lists and counts are equal except for pairs whose f64
distance lies within 2 ulp of the radius.

Builds.  ``vp_shape`` and ``_build_host`` (NumPy in both packages) are
equal bit for bit.  The native builder and the device build are equal bit
for bit where every distance is exact (small-integer coordinates under
Euclidean; the native builder under every metric): the JAX package's
native library is built with ``-march=native``, so g++ fuses its distance
loops into FMAs, XLA contracts the device build's sums into FMAs as well,
and torch's CPU ``sqrt`` and ``pow`` are not correctly rounded (1,363 of
200,000 f32 square roots differ from IEEE's in one ulp).  On real-valued
data the structure (``near``, ``far``, ``root``, ``depth``) stays equal
bit for bit, the vantage points are equal, and the radii agree within
4·eps (absolute below 1)."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu import native as jax_native
from petal_neighbors_tpu.distance import get_metric as jax_metric
from petal_neighbors_tpu.trees import vantage as jv
from petal_neighbors_tpu.trees import vantage_build_device as jvd
from petal_neighbors_tpu_torch import native
from petal_neighbors_tpu_torch.convert import vptree_from_jax_arrays
from petal_neighbors_tpu_torch.distance import get_metric as port_metric
from petal_neighbors_tpu_torch.ops import bruteforce as tbf
from petal_neighbors_tpu_torch.trees import vantage as tv
from petal_neighbors_tpu_torch.trees import vantage_build_device as tvd

from test_torch_ball_tree import assert_knn_match

METRICS = {"euclidean": ("euclidean", {}), "cosine": ("cosine", {}),
           "minkowski3": ("minkowski", {"p": 3.0})}
STATS_KEYS = {"per_query": {"n_subtrees", "loop_chunks", "chunk_size",
                            "subtrees_surviving_final_bound", "prune_ratio",
                            "trunk_size"},
              "tiled": {"n_subtrees", "loop_chunks", "chunk_size",
                        "n_tiles", "trunk_size"}}
NODE_KEYS = ("vantage_point", "radius", "near", "far")


def _metrics(name):
    metric, kw = METRICS[name]
    return jax_metric(metric, **kw), port_metric(metric, **kw)


def _data(n, d, dtype, q, seed=0):
    rng = np.random.default_rng(seed + 13 * n + d)
    pts = rng.normal(size=(n, d)).astype(dtype)
    qs = rng.normal(size=(q, d)).astype(dtype)
    pts[[4, 17], 0] = np.nan                   # NaN rows
    pts[30:34] = pts[29]                       # duplicated rows
    qs[2, -1] = np.nan                         # a NaN query
    qs[3] = pts[29]                            # a query on the duplicates
    return pts, qs


def _int_data(n, d, dtype, seed=0):
    """Small-integer coordinates: every difference, square and sum is
    exact in either dtype, with NaN rows and duplicates."""
    pts = np.random.default_rng(seed + n + d).integers(
        -8, 9, size=(n, d)).astype(dtype)
    if n > 40:
        pts[[4, 17], 0] = np.nan
        pts[30:34] = pts[29]
    return pts


def _arrays(jt, pts):
    return {"points": pts, "vp": np.asarray(jt.nodes["vantage_point"]),
            "radius": np.asarray(jt.nodes["radius"]),
            "near": np.asarray(jt.nodes["near"]),
            "far": np.asarray(jt.nodes["far"]), "root": jt.root,
            "depth": jt._static.depth}


def _pair(pts, name, builder="host"):
    """The JAX tree, and the port's tree on the JAX tree's own arrays: the
    query engines compared on one tree."""
    jm, tm = _metrics(name)
    jt = jpn.VantagePointTree(pts, jm, builder=builder)
    return jt, vptree_from_jax_arrays(_arrays(jt, pts), metric=tm,
                                      device="cpu")


def _assert_built_equal(jb, tb, exact: bool):
    """(vp, radius, near, far, root, depth) of the two builds: the
    structure bit for bit, and the radii bit for bit (``exact``) or within
    4·eps, NaN and the leaves' dtype max in the same slots."""
    for key, a, b in zip(("vp", "radius", "near", "far"), jb[:4], tb[:4]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key == "radius" and not exact:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            big = a == np.finfo(a.dtype).max
            np.testing.assert_array_equal(big, b == np.finfo(a.dtype).max)
            eps = 4 * np.finfo(a.dtype).eps
            ok = ~np.isnan(a)
            np.testing.assert_allclose(b[ok], a[ok], rtol=eps, atol=eps)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert (int(jb[4]), int(jb[5])) == (int(tb[4]), int(tb[5]))


# ---- builds -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 150, 1000])
def test_vp_shape_matches_jax(n):
    a, b = jvd.vp_shape(n), tvd.vp_shape(n)
    assert (a.n, a.depth, a.n_nodes) == (b.n, b.depth, b.n_nodes)
    for key in ("near", "far", "is_leaf"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(METRICS) + ["manhattan"])
def test_build_host_matches_jax(name, dtype):
    """``_build_host`` (NumPy in both) bit for bit; Manhattan, which has no
    native kind, takes it through the trees' host builder."""
    pts, _ = _data(300, 3, dtype, q=4, seed=1)
    if name == "manhattan":
        jt = jpn.VantagePointTree(pts, jax_metric("manhattan"),
                                  builder="host")
        tt = tpn.VantagePointTree(pts, "manhattan", builder="host",
                                  device="cpu")
        for key in NODE_KEYS:
            np.testing.assert_array_equal(tt.nodes[key],
                                          np.asarray(jt.nodes[key]))
        assert (tt.root, tt.depth) == (jt.root, jt._static.depth)
        return
    jm, tm = _metrics(name)
    _assert_built_equal(jv._build_host(pts, jm), tv._build_host(pts, tm),
                        exact=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_native_build_matches_jax(name, dtype):
    jm, tm = _metrics(name)
    for n, d in ((1, 3), (7, 2), (300, 2), (300, 5)):
        pts = _int_data(n, d, dtype)
        jt = jpn.VantagePointTree(pts, jm, builder="host")
        tt = tpn.VantagePointTree(pts, tm, builder="host", device="cpu")
        assert tt.builder == "host"
        _assert_built_equal([jt.nodes[k] for k in NODE_KEYS]
                            + [jt.root, jt._static.depth],
                            [tt.nodes[k] for k in NODE_KEYS]
                            + [tt.root, tt.depth], exact=True)
    pts = np.random.default_rng(2).normal(size=(400, 5)).astype(dtype)
    _assert_built_equal(jax_native.vp_build(pts, jm),
                        native.vp_build(pts, tm), exact=False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_device_build_matches_jax(name, dtype):
    jm, tm = _metrics(name)
    if name == "euclidean":
        for n, d in ((1, 2), (2, 5), (7, 2), (300, 2), (300, 5)):
            pts = _int_data(n, d, dtype)
            jb = jvd.build_device(pts, jm)
            tb = tvd.build_device(torch.from_numpy(pts), tm)
            _assert_built_equal(jb, tb, exact=False)
            # the squares and sums are exact: only the square root rounds
            a, b = np.asarray(jb[1]), tb[1]
            ok = ~np.isnan(a) & (a < np.finfo(dtype).max)
            assert (np.abs(a[ok] - b[ok]) <= np.spacing(a[ok])).all()
    for n, d in ((2, 5), (300, 2), (1000, 5)):
        pts = np.random.default_rng(n + d).normal(size=(n, d)).astype(dtype)
        _assert_built_equal(jvd.build_device(pts, jm),
                            tvd.build_device(torch.from_numpy(pts), tm),
                            exact=False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_build_sorts_nan_last(dtype):
    """A segment with NaN distances: the vantage row keeps its place and
    every NaN distance sorts last, so the root's near half and radius are
    the host builder's."""
    pts = np.random.default_rng(3).normal(size=(41, 2)).astype(dtype)
    pts[[0, 5, 6, 11, 30], 1] = np.nan
    metric = port_metric("euclidean")
    vp, radius, near, far, root, _ = tvd.build_device(torch.from_numpy(pts),
                                                      metric)
    hvp, hradius, hnear, hfar, hroot, _ = tv._build_host(pts, metric)
    assert vp[root] == hvp[hroot] == 40
    assert radius[root] == hradius[hroot] and np.isfinite(radius[root])

    def members(vp, near, far, node):
        out, st = [], [node]
        while st:
            x = st.pop()
            if x >= 0:
                out.append(int(vp[x]))
                st += [near[x], far[x]]
        return sorted(out)
    assert members(vp, near, far, near[root]) == members(
        hvp, hnear, hfar, hnear[hroot])
    assert {0, 5, 6, 11, 30} <= set(members(vp, near, far, far[root]))
    # a NaN vantage point: every distance of its segment is NaN
    pts[-1] = np.nan
    jb = jvd.build_device(pts, jax_metric("euclidean"))
    tb = tvd.build_device(torch.from_numpy(pts), metric)
    _assert_built_equal(jb, tb, exact=False)
    assert np.isnan(tb[1][tb[4]])


def test_auto_builder_and_errors(tmp_path):
    pts = np.random.default_rng(4).normal(size=(50, 3))
    tt = tpn.VantagePointTree(pts, device="cpu")
    assert tt.builder == "host"             # a CPU index never builds on it
    assert tpn.VantagePointTree(pts, builder="device",
                                device="cpu").builder == "device"
    with pytest.raises(tpn.EmptyArrayError):
        tpn.VantagePointTree(np.zeros((0, 3)), device="cpu")
    with pytest.raises(tpn.NotContiguousError):
        tpn.VantagePointTree(np.asfortranarray(pts), device="cpu")
    with pytest.raises(ValueError, match="triangle"):
        tpn.VantagePointTree(pts, "sqeuclidean", device="cpu")
    with pytest.raises(ValueError, match="builder"):
        tpn.VantagePointTree(pts, builder="nope", device="cpu")
    with pytest.raises(ValueError):
        tpn.VantagePointTree(pts, tpn.Haversine(), device="cpu")
    tt.save(tmp_path / "x.npz")                     # the serialize slice
    back = tpn.load_index(tmp_path / "x.npz", device="cpu")
    np.testing.assert_array_equal(back.nodes["vantage_point"],
                                  tt.nodes["vantage_point"])
    with pytest.raises(ValueError, match="scheme"):
        tt.query_batch(pts, 2, scheme="nope")
    with pytest.raises(ValueError, match="kernel"):
        tt.query_batch(pts, 2, scheme="kernel")      # n < 4096
    with pytest.raises(ValueError):
        tt.query_batch(np.zeros((2, 4)), 1)
    assert tt.query_batch(pts, 0, with_stats=True)[2] == {}
    d, i = tt.query_batch(pts, 0)
    assert d.shape == i.shape == (50, 0) and i.dtype == torch.int32


# ---- the flattening and the scans -------------------------------------------

@pytest.mark.parametrize("n,target", [(1, 1), (7, 2), (128, 16), (513, 64),
                                      (2000, 64)])
def test_flatten_matches_jax(n, target):
    pts = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    built = tv._build_host(pts, port_metric("euclidean"))
    for jfn, tfn in ((jv._flatten_for_query, tv._flatten_for_query),
                     (jv._flatten_for_query_reference,
                      tv._flatten_for_query_reference)):
        for a, b in zip(jfn(*built[:5], target=target),
                        tfn(*built[:5], target=target)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(METRICS))
@pytest.mark.parametrize("d", [2, 5])
def test_knn_matches_jax(d, name, dtype):
    """per_query and tiled at k in {1, 5, 12}: results, stats keys and
    counts equal to the JAX tree's."""
    pts, qs = _data(700, d, dtype, q=300)
    jt, tt = _pair(pts, name)
    for k in (1, 5, 12):
        for scheme in ("per_query", "tiled"):
            jd, ji, js = jt.query_batch(qs, k, scheme=scheme,
                                        with_stats=True)
            td, ti, ts = tt.query_batch(qs, k, scheme=scheme,
                                        with_stats=True)
            assert_knn_match((jd, ji), (td, ti), dtype)
            assert set(ts) == set(js) == STATS_KEYS[scheme]
            for key in STATS_KEYS[scheme] - {
                    "subtrees_surviving_final_bound", "prune_ratio"}:
                assert int(ts[key]) == int(js[key]), key
            if scheme == "per_query":
                # the counts compare bounds with the k-th distance: equal
                # where the k-th is bit for bit (another summation order,
                # or cosine's cancellation near 0, moves it by an ulp)
                same = td[:, -1].numpy() == np.asarray(jd)[:, -1]
                np.testing.assert_array_equal(
                    ts["subtrees_surviving_final_bound"].numpy()[same],
                    np.asarray(js["subtrees_surviving_final_bound"])[same])
                np.testing.assert_allclose(
                    ts["prune_ratio"].numpy()[same],
                    np.asarray(js["prune_ratio"])[same], rtol=1e-6)
            assert np.isposinf(td[2].numpy()).all()     # the NaN query
            np.testing.assert_array_equal(
                tt.query_batch(qs, k, scheme=scheme)[1], ti)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_auto_matches_jax_and_takes_the_scans_on_cpu(dtype, monkeypatch):
    """A CPU index takes the scans under "auto", as the JAX package does on
    a CPU: tiled for 2048 to 8191 queries at d <= 8 and k <= 16, else per
    query; it never reaches the kernel route."""
    pts, qs = _data(5000, 2, dtype, q=2100, seed=1)
    jt, tt = _pair(pts, "euclidean")

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel route ran on a CPU index")
    monkeypatch.setattr(tbf, "knn_prepadded", no_kernel)
    for k, q in ((3, 2100), (3, 40), (20, 2100)):
        assert_knn_match(jt.query_batch(qs[:q], k),
                         tt.query_batch(qs[:q], k), dtype)
    assert tt.query_batch(qs, 3, with_stats=True)[2]["n_tiles"] == 17
    assert "n_tiles" not in tt.query_batch(qs[:40], 3, with_stats=True)[2]


def test_partial_final_chunk_matches_jax():
    """Chunk sizes that leave a partial last chunk pad with the
    out-of-range sentinel: no duplicate ids, the JAX engine's results."""
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((300, 3))
    qs = pts[:40] + 0.01 * rng.standard_normal((40, 3))
    jt, tt = _pair(pts, "euclidean")
    jtab, ttab = jt._flat_tables(), tt._flat_tables()
    S = ttab[1].shape[0]
    for C in (1, 2, 3, 4, 5, 7):
        if S % C == 0:
            continue
        jout = jv._vp_knn_flat(pts, qs, *jtab, k=5, metric=jt.metric,
                               chunk=C)
        tout = tv._vp_knn_flat(tt.points, torch.from_numpy(qs), *ttab, k=5,
                               metric=tt.metric, chunk=C)
        assert_knn_match(jout, tout, np.float64)
        assert all(len(set(r)) == 5 for r in tout[1].tolist())


def test_k_edges_and_single_query_api():
    pts, qs = _data(513, 2, np.float64, q=4, seed=2)
    jt, tt = _pair(pts, "euclidean")
    for k in (513, 600):              # every subtree scanned, all n back
        assert_knn_match(jt.query_batch(qs, k, scheme="per_query"),
                         tt.query_batch(qs, k, scheme="per_query"),
                         np.float64)
    q = qs[0]
    assert tt.query_nearest(q)[0] == jt.query_nearest(q)[0]
    assert tt.query_nearest(q)[1] == pytest.approx(jt.query_nearest(q)[1],
                                                   rel=1e-12)
    ti, td = tt.query(q, 6)
    ji, jd = jt.query(q, 6)
    assert ti.dtype == np.int64 and td.dtype == np.float64
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-12)
    i0, d0 = tt.query(q, 0)
    assert i0.shape == d0.shape == (0,)
    assert len(tt.query(q, 10 ** 4)[0]) == 513
    np.testing.assert_array_equal(tt.query_nearest_batch(qs)[0].numpy(),
                                  np.asarray(jt.query_nearest_batch(qs)[0]))
    one = tpn.VantagePointTree(pts[:1], device="cpu")
    assert one.query_nearest(q)[0] == 0


# ---- the kernel route -------------------------------------------------------

@pytest.mark.parametrize("n,d,k,scheme", [(4096, 2, 5, "fold"),
                                          (4096, 40, 12, "fold"),
                                          (16384, 2, 1, "capped")])
def test_forced_kernel_matches_jax(n, d, k, scheme):
    """A forced "kernel" on the CPU (the plain versions) against the JAX
    tree's ``_kernel_knn`` in interpret mode; duplicates keep their
    multiplicity."""
    rng = np.random.default_rng(n + d)
    pts = (rng.normal(size=(n, d)) * 10 + 5).astype(np.float32)
    qs = (rng.normal(size=(64, d)) * 10 + 5).astype(np.float32)
    pts[100:110] = pts[99]
    qs[5] = pts[99]
    jt, tt = _pair(pts, "euclidean")
    td, ti, stats = tt.query_batch(qs, k, scheme="kernel", with_stats=True)
    assert stats == {"kernel_scheme": scheme}
    band = 4 * np.finfo(np.float32).eps * (np.abs(pts).max()
                                           + np.abs(qs).max())
    assert_knn_match(jt._kernel_knn(qs, k, interpret=True), (td, ti),
                     np.float32, rd_atol=2 * band * float(td.max()))
    if k > 1:
        assert set(ti[5, :10].tolist()) >= set(range(99, 99 + min(k, 10)))
    # the same ids as the per-query scan
    assert_knn_match(tt.query_batch(qs, k, scheme="per_query"), (td, ti),
                     np.float32, rd_atol=2 * band * float(td.max()))


def _gate_table():
    rng = np.random.default_rng(6)
    big = rng.normal(size=(4096, 2)).astype(np.float32)
    nan = big.copy()
    nan[7] = np.nan
    return [(big, "euclidean", 5), (big, "euclidean", 0),
            (big, "euclidean", tbf.PALLAS_K_MAX),
            (big, "euclidean", tbf.PALLAS_K_MAX + 1),
            (big[:4095], "euclidean", 5), (big.astype(np.float64),
                                            "euclidean", 5),
            (big, "cosine", 5), (big, "minkowski3", 5), (nan, "euclidean", 5),
            (rng.normal(size=(4096, 40)).astype(np.float32), "euclidean", 9)]


def test_kernel_route_ok_matches_jax(monkeypatch):
    """The gate, less the JAX package's availability test (patched to
    true): dtype, metric, n, k and NaN rows."""
    import petal_neighbors_tpu.ops.pallas.knn_kernel as jkk
    monkeypatch.setattr(jkk, "pallas_available", lambda: True)
    for pts, name, k in _gate_table():
        jm, tm = _metrics(name)
        jt = jpn.VantagePointTree(pts, jm)
        tt = tpn.VantagePointTree(pts, tm, device="cpu")
        assert tt._kernel_route_ok(8, k) == jt._kernel_route_ok(8, k), (
            pts.shape, pts.dtype, name, k)
    # past 2,097,152 points at d <= 32 the tree engines serve (the size
    # test comes before the tables are made)
    tt = tpn.VantagePointTree(np.zeros((1, 2), np.float32), device="cpu")
    monkeypatch.setattr(tpn.VantagePointTree, "n",
                        property(lambda self: 2_097_153))
    assert not tt._kernel_route_ok(8, 5)


def test_kernel_failure_raises_under_auto(monkeypatch):
    """With the route open under "auto", a kernel failure raises; nothing
    falls back to the scans."""
    pts = np.random.default_rng(7).normal(size=(4096, 2)).astype(np.float32)
    tt = tpn.VantagePointTree(pts, device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(tbf, "knn_prepadded", broken)
    monkeypatch.setattr(type(tt), "_auto_kernel",
                        lambda self, q, k: self._kernel_route_ok(q, k))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tt.query_batch(pts[:8], 5)
    # with stats the scans answer, as in the JAX package
    assert "loop_chunks" in tt.query_batch(pts[:8], 5, with_stats=True)[2]


# ---- radius -----------------------------------------------------------------

def _rd64(pts, qs):
    d = ((qs[:, None, :].astype(np.float64) - pts[None].astype(np.float64))
         ** 2).sum(-1)
    return np.where(np.isnan(d), np.inf, d)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_radius_matches_jax(name, dtype):
    pts, qs = _data(400, 3, dtype, q=60, seed=3)
    jt, tt = _pair(pts, name)
    r = 0.5 if name != "cosine" else 0.1
    if name == "euclidean":
        rr = r * r
        near = np.abs(_rd64(pts, qs) - rr) <= 2 * float(
            np.spacing(dtype(rr)))
    else:
        near = np.zeros((len(qs), len(pts)), bool)
    exact = ~near.any(axis=1)
    jm = np.asarray(jt.query_radius_batch(qs, r))
    tm = tt.query_radius_batch(qs, r).numpy()
    assert tm.dtype == bool and tm.any() and not tm[:, [4, 17]].any()
    assert not ((jm != tm) & ~near).any()
    for cap in (3, 64, 400):
        ji, jc = (np.asarray(a) for a in jt.query_radius_batch(qs, r,
                                                               cap=cap))
        ti, tc = (a.numpy() for a in tt.query_radius_batch(qs, r, cap=cap))
        assert ti.dtype == tc.dtype == np.int32 and ti.shape == (60, cap)
        np.testing.assert_array_equal(ti[exact], ji[exact])
        np.testing.assert_array_equal(tc[exact], jc[exact])
        if cap == 3:
            assert (tc > cap).any()                   # counts past the cap
        if name == "cosine":
            # cosine distance breaks the triangle inequality, so the tree's
            # pruning may drop members the mask has; the JAX tree drops
            # the same ones (above)
            continue
        np.testing.assert_array_equal(tc, tm.sum(axis=1))
        for row in np.flatnonzero(tc <= cap):
            assert sorted(ti[row, :tc[row]].tolist()) == \
                np.flatnonzero(tm[row]).tolist()
    assert tt.last_radius_steps % tv.RADIUS_CHECK_EVERY == 0
    assert tt.query_radius(qs[0], r).tolist() == sorted(
        jt.query_radius(qs[0], r).tolist())


def test_radius_check_stride_changes_nothing(monkeypatch):
    """Reading the stop test every step or every 16 steps gives the same
    ids and counts; the strided run takes at most 15 steps more."""
    pts, qs = _data(300, 2, np.float32, q=50, seed=4)
    tt = tpn.VantagePointTree(pts, device="cpu")
    a = tt.query_radius_batch(qs, 0.4, cap=16)
    steps = tt.last_radius_steps
    monkeypatch.setattr(tv, "RADIUS_CHECK_EVERY", 1)
    b = tt.query_radius_batch(qs, 0.4, cap=16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert 0 <= steps - tt.last_radius_steps < 16


def test_radius_reference_cases():
    """The JAX package's own cases (test_vantage.py:334-366): inclusive
    boundary, a NaN root vantage point, counts past the cap."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (90, 2))
    tt = tpn.VantagePointTree.euclidean(pts, device="cpu")
    q = rng.uniform(0, 1, 2)
    od = np.sqrt(((pts - q[None]) ** 2).sum(-1))
    assert tt.query_radius(q, 0.3).tolist() == np.flatnonzero(
        od <= 0.3).tolist()
    r = float(np.sort(od)[10])                 # a point exactly at r
    assert len(tt.query_radius(q, r)) == 11
    pts[89] = np.nan
    tt = tpn.VantagePointTree.euclidean(pts, device="cpu")
    mask = tt.query_radius_batch(pts[:5], 0.25).numpy()
    ids, cnt = tt.query_radius_batch(pts[:5], 0.25, cap=90)
    for row in range(5):
        got = set(ids[row][ids[row] >= 0].tolist())
        assert got == set(np.flatnonzero(mask[row]).tolist())
    ids, cnt = tt.query_radius_batch(pts[:3], 5.0, cap=10)
    assert (cnt == 89).all() and (ids >= 0).all()


# ---- carry-over -------------------------------------------------------------

@pytest.mark.parametrize("builder", ["host", "device"])
def test_vptree_from_jax_arrays(builder):
    pts, qs = _data(300, 3, np.float32, q=40, seed=6)
    jt, tt = _pair(pts, "euclidean", builder=builder)
    for key in NODE_KEYS:
        np.testing.assert_array_equal(tt.nodes[key],
                                      np.asarray(jt.nodes[key]))
    assert tt.builder is None and tt.root == jt.root
    for scheme in ("per_query", "tiled"):
        assert_knn_match(jt.query_batch(qs, 4, scheme=scheme),
                         tt.query_batch(qs, 4, scheme=scheme), np.float32)
    arrays = _arrays(jt, pts)
    with pytest.raises(KeyError):
        vptree_from_jax_arrays({"points": pts}, device="cpu")
    with pytest.raises(ValueError):
        vptree_from_jax_arrays(dict(arrays, far=arrays["far"][:-1]),
                               device="cpu")
