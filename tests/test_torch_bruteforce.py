"""The port's BruteForce (on the CPU: the fold kernel's plain version or
the scan) against the JAX BruteForce (its XLA path on the CPU), end to
end on shared numpy inputs.

Tolerance: distances rtol 1e-4 / atol 1e-4 in float32 — both sides end in
a direct-form rescore, but on differently centered copies and summed in
different orders — and rtol 1e-10 in float64.  Ids are compared as sets
except where the k-th exact distance is tied.  Known difference: at k
above the finite row count (NaN points) the kernel route returns
(+inf, -1) where the JAX XLA path returns real ids at +inf; distances
are compared there, not ids."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.ops import bruteforce as jbf
from petal_neighbors_tpu_torch.convert import bruteforce_from_jax_arrays
from petal_neighbors_tpu_torch.ops import bruteforce as tbf

N_Q = 24


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-4) if dtype == np.float32 else \
        dict(rtol=1e-10, atol=1e-10)


def _data(n, d, dtype, seed=0, nan_rows=(), nan_queries=()):
    rng = np.random.default_rng(seed + n + d)
    pts = (rng.normal(size=(n, d)) * 10 + 3).astype(dtype)
    qs = (rng.normal(size=(N_Q, d)) * 10 + 3).astype(dtype)
    for r in nan_rows:
        pts[r, 0] = np.nan
    for r in nan_queries:
        qs[r, -1] = np.nan
    return pts, qs


def _tied(pts, q, k):
    ok = ~np.isnan(pts).any(axis=1)
    d = np.sort(((pts[ok].astype(np.float64) - q) ** 2).sum(1))
    return k < len(d) and d[k] - d[k - 1] <= 1e-4 * max(d[k], 1e-12)


def _compare(pts, qs, k, jidx, tidx):
    jd, ji = (np.asarray(a) for a in jidx.query_batch(jnp.asarray(qs), k))
    td, ti = tidx.query_batch(qs, k)
    td, ti = td.numpy(), ti.numpy()
    assert td.shape == jd.shape == (N_Q, min(k, len(pts)))
    assert td.dtype == pts.dtype and ti.dtype == np.int32
    np.testing.assert_allclose(td, jd, **_tol(pts.dtype))
    assert (td[:, 1:] >= td[:, :-1]).all()
    # NaN points are never selected at a finite distance (the scan may
    # fill +inf slots with them, as the JAX XLA path does)
    bad = np.isnan(pts).any(axis=1)
    assert not bad[ti[(ti >= 0) & np.isfinite(td)]].any()
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    if k <= (~bad).sum():          # else: the known difference, no ids
        for r in np.flatnonzero(~nanq):
            if k and not _tied(pts, qs[r].astype(np.float64), k):
                assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    return td, ti


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [2, 64, 128])
@pytest.mark.parametrize("n", [100, 5000])
def test_query_batch_matches_jax(n, d, dtype):
    pts, qs = _data(n, d, dtype)
    jidx = jpn.BruteForce.euclidean(pts)
    tidx = tpn.BruteForce.euclidean(pts, device="cpu")
    for k in (0, 1, 10, 100, n + 5):
        _compare(pts, qs, k, jidx, tidx)
        k_eff = min(k, n)
        want = ("kernel" if dtype == np.float32
                and 1 <= k_eff <= tbf.PALLAS_K_MAX else "scan")
        assert tidx.last_backend == want, (k, tidx.last_backend)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [2, 64])
@pytest.mark.parametrize("n", [100, 5000])
def test_nan_points_and_queries(n, d, dtype):
    pts, qs = _data(n, d, dtype, seed=1, nan_rows=(0, 5, n - 1),
                    nan_queries=(0, 7))
    jidx = jpn.BruteForce.euclidean(pts)
    tidx = tpn.BruteForce.euclidean(pts, device="cpu")
    for k in (1, 10, 100):
        _compare(pts, qs, k, jidx, tidx)
    # k above the finite row count: distances only (see module docstring)
    td, ti = _compare(pts, qs, n, jidx, tidx)
    finite = np.isfinite(td)
    assert (ti[finite] >= 0).all()


@pytest.mark.parametrize("n", [100, 5000])
def test_sqeuclidean_matches_jax(n):
    pts, qs = _data(n, 64, np.float32, seed=2)
    jidx = jpn.BruteForce(pts, "sqeuclidean")
    tidx = tpn.BruteForce(pts, "sqeuclidean", device="cpu")
    for k in (1, 10):
        td, _ = _compare(pts, qs, k, jidx, tidx)
        assert tidx.last_backend == "scan"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_query_and_query_nearest(dtype):
    pts, qs = _data(300, 64, dtype, seed=3)
    jidx = jpn.BruteForce.euclidean(pts)
    tidx = tpn.BruteForce.euclidean(pts, device="cpu")
    ji, jd = jidx.query(qs[0], 7)
    ti, td = tidx.query(qs[0], 7)
    assert isinstance(ti, np.ndarray) and isinstance(td, np.ndarray)
    np.testing.assert_allclose(td, jd, **_tol(dtype))
    assert set(ti.tolist()) == set(np.asarray(ji).tolist())
    assert tidx.query(qs[0], 0)[0].shape == (0,)
    assert tidx.query(qs[0], 1000)[0].shape == (300,)
    i1, d1 = tidx.query_nearest(qs[1])
    i2, d2 = jidx.query_nearest(qs[1])
    assert i1 == i2 and isinstance(i1, int)
    assert d1 == pytest.approx(d2, rel=1e-5)
    # a point of the index is its own nearest neighbour, at distance 0
    assert tidx.query_nearest(pts[17]) == (17, 0.0)


def test_typed_errors():
    with pytest.raises(tpn.EmptyArrayError):
        tpn.BruteForce.euclidean(np.zeros((0, 3), np.float32), device="cpu")
    with pytest.raises(tpn.EmptyArrayError):
        tpn.BruteForce.euclidean(np.zeros((4, 0), np.float32), device="cpu")
    fortran = np.asfortranarray(np.ones((5, 3), np.float32))
    with pytest.raises(tpn.NotContiguousError):
        tpn.BruteForce.euclidean(fortran, device="cpu")
    idx = tpn.BruteForce.euclidean(np.ones((5, 3), np.float32), device="cpu")
    with pytest.raises(ValueError):
        idx.query_batch(np.ones((2, 4), np.float32), 1)
    with pytest.raises(ValueError):
        idx.query(np.ones(4, np.float32), 1)
    with pytest.raises(ValueError):
        tpn.BruteForce.euclidean(np.ones(5, np.float32), device="cpu")
    assert issubclass(tpn.EmptyArrayError, tpn.ArrayError)
    assert isinstance(tpn.get_metric("cosine"), tpn.Cosine)
    with pytest.raises(ValueError):
        tpn.get_metric("nope")
    # radius search: a wrong query dim raises as in query
    assert idx.query_radius(np.ones(3, np.float32), 1.0).tolist() == [
        0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        idx.query_radius(np.ones(4, np.float32), 1.0)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpn.BruteForce.euclidean(np.ones((5, 3), np.float32))


def test_integer_input_promotes_to_f32():
    pts = np.arange(40, dtype=np.int64).reshape(10, 4)
    idx = tpn.BruteForce.euclidean(pts, device="cpu")
    d, i = idx.query_batch(pts[:2], 2)
    assert d.dtype == torch.float32
    assert i[:, 0].tolist() == [0, 1]


def test_large_k_takes_the_scan():
    """Only k above PALLAS_K_MAX = 4088 leaves the kernel route; k + 8 >
    1024 runs merge."""
    pts, qs = _data(4200, 64, np.float32, seed=4)
    jidx = jpn.BruteForce.euclidean(pts)
    tidx = tpn.BruteForce.euclidean(pts, device="cpu")
    _compare(pts, qs, 4089, jidx, tidx)
    assert (tidx.last_backend, tidx.last_scheme) == ("scan", None)
    _compare(pts, qs, 4088, jidx, tidx)
    assert (tidx.last_backend, tidx.last_scheme) == ("kernel", "merge")
    _compare(pts, qs, 1020, jidx, tidx)
    assert (tidx.last_backend, tidx.last_scheme) == ("kernel", "merge")


@pytest.mark.parametrize("n,d", [(700, 64), (300, 8)])
def test_prepare_euclidean_index_matches_jax(n, d):
    pts, _ = _data(n, d, np.float32, seed=5, nan_rows=(2, 99))
    mu, ppad, pnorm, _, bad, _ = jbf.prepare_euclidean_index(
        jnp.asarray(pts), 512, with_split=False, with_bcap=False)
    tmu, tppad, tpnorm, tbad = tbf.prepare_euclidean_index(
        torch.from_numpy(pts), tn=512)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-5,
                               atol=1e-5)
    assert tppad.shape == ppad.shape
    np.testing.assert_allclose(tppad.numpy(), np.asarray(ppad), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tpnorm.numpy(), np.asarray(pnorm), rtol=1e-4)
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(bad))
    assert np.isposinf(tpnorm.numpy()[[2, 99]]).all()
    assert (tppad.numpy()[[2, 99]] == 0).all()


def test_bruteforce_from_jax_arrays():
    pts, qs = _data(3000, 128, np.float32, seed=6, nan_rows=(10,))
    mu, ppad, pnorm, _, bad, _ = jbf.prepare_euclidean_index(
        jnp.asarray(pts), jbf.pad_granule(128), with_split=False,
        with_bcap=False)
    arrays = dict(points=pts, center=np.asarray(mu), ppad=np.asarray(ppad),
                  pnorm=np.asarray(pnorm), bad=np.asarray(bad))
    carried = bruteforce_from_jax_arrays(arrays, device="cpu")
    built = tpn.BruteForce.euclidean(pts, device="cpu")
    assert carried.num_points == 3000 and carried.dim == 128
    for k in (1, 10, 100):
        cd, ci = carried.query_batch(qs, k)
        bd, bi = built.query_batch(qs, k)
        assert carried.last_backend == "kernel"
        np.testing.assert_allclose(cd.numpy(), bd.numpy(), rtol=1e-5)
        for r in range(N_Q):
            if not _tied(pts, qs[r].astype(np.float64), k):
                assert set(ci[r].tolist()) == set(bi[r].tolist())
    # a ppad of any row count >= n is taken, padded to whole bcap blocks
    odd = bruteforce_from_jax_arrays(
        dict(arrays, ppad=arrays["ppad"][:3001], pnorm=arrays["pnorm"][:3001]),
        device="cpu")
    assert odd._pts.shape[0] % tbf.PAD_ROWS == 0
    assert np.isposinf(odd._norms[3000:].numpy()).all()
    od, oi = odd.query_batch(qs, 10)
    np.testing.assert_allclose(od.numpy(), built.query_batch(qs, 10)[0].numpy(),
                               rtol=1e-5)
    with pytest.raises(KeyError):
        bruteforce_from_jax_arrays({"points": pts}, device="cpu")
    with pytest.raises(ValueError):
        bruteforce_from_jax_arrays(dict(arrays, center=np.zeros(3)),
                                   device="cpu")


# ---- the proof-gated schemes: bcap and capped with the fold repair --------

def _oracle(pts, qs, k):
    d2 = np.sqrt(((qs[:, None].astype(np.float64)
                   - pts[None].astype(np.float64)) ** 2).sum(-1))
    d2 = np.where(np.isnan(d2), np.inf, d2)
    oi = np.argsort(d2, 1, kind="stable")[:, :k]
    return np.take_along_axis(d2, oi, 1), oi


@pytest.mark.parametrize("scheme", ["capped", "bcap"])
@pytest.mark.parametrize("k,passes", [(10, None), (10, 0), (40, 2)])
def test_proof_gated_route_matches_jax(scheme, k, passes, monkeypatch):
    """The port's route against the JAX package's on the same padded
    index, both against the f64 oracle.  ``passes=0`` leaves every tile's
    smallest candidate out, so the proof fails for most queries and the
    fold repair answers them."""
    rng = np.random.default_rng(k)
    n, d = 8192, 32
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((N_Q, d)).astype(np.float32)
    pts[[7, 4000]] = np.nan
    qs[3] = np.nan
    mu = jbf.center_of(jnp.asarray(pts))
    pp, pn = jbf.pad_for_pallas(jnp.asarray(pts) - mu, tn=2048)
    jkw = dict(precision="highest", interpret=True, scheme=scheme,
               capped_passes=passes)
    if scheme == "bcap":
        from petal_neighbors_tpu.ops.pallas.knn_kernel import (
            prepare_bcap_planes)
        jkw.update(tn=2048, bcap_tn=2048, bcap_planes=prepare_bcap_planes(
            pp, pn, tn=2048, precision="highest"))
    else:
        jkw.update(tn=512)
    jd, ji = (np.asarray(a) for a in jbf.knn_pallas_prepadded(
        pp, pn, jnp.asarray(qs), k, n, mu, **jkw))
    folds = []
    fold = tbf.knn_fold
    monkeypatch.setattr(tbf, "knn_fold",
                        lambda *a, **kw: folds.append(len(a[1])) or
                        fold(*a, **kw))
    if passes is not None:
        monkeypatch.setattr(tbf, "capped_passes", lambda *a: passes)
    td, ti = tbf.knn_prepadded(
        torch.from_numpy(np.array(pp)), torch.from_numpy(np.array(pn)),
        torch.from_numpy(qs), k, n, torch.from_numpy(np.array(mu)),
        scheme=scheme)
    td, ti = td.numpy(), ti.numpy()
    od, oi = _oracle(pts, qs, k)
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    np.testing.assert_allclose(td[~nanq], od[~nanq], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td[~nanq], jd[~nanq], rtol=1e-4, atol=1e-4)
    for r in np.flatnonzero(~nanq):
        if not _tied(pts, qs[r].astype(np.float64), k):
            assert set(ti[r].tolist()) == set(oi[r].tolist()), r
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    if passes == 0:
        # the repair ran once, on the uncovered queries only
        assert len(folds) == 1 and 0 < folds[0] < N_Q


def test_proof_gated_route_repairs_identical_points():
    """All-equal points: every tile overflows its passes, the proof cannot
    certify, and the fold repair still gives the exact distances."""
    rng = np.random.default_rng(8)
    pts = np.ones((4096, 8), np.float32)
    qs = rng.standard_normal((N_Q, 8)).astype(np.float32)
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    want = np.sqrt(((qs - 1.0) ** 2).sum(-1))
    for scheme in ("capped", "bcap"):
        dd, ii = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), 5, 4096, mu,
                                   scheme=scheme)
        np.testing.assert_allclose(dd.numpy(), np.repeat(want[:, None], 5, 1),
                                   rtol=1e-5, atol=1e-5)
        assert (ii.numpy() >= 0).all()
        assert all(len(set(r)) == 5 for r in ii.tolist())


def test_serving_scale_routes_match_jax():
    """At n >= 262144 the index serves k=10 by bcap, and k=100 and k=200 by
    capped (the JAX package's cutovers), each exact against the JAX
    BruteForce."""
    rng = np.random.default_rng(9)
    n, d = 262144, 4
    pts = rng.random((n, d), dtype=np.float32) * 255
    qs = rng.random((N_Q, d), dtype=np.float32) * 255
    pts[[5, 1000]] = np.nan
    qs[2] = np.nan
    jidx = jpn.BruteForce.euclidean(pts)
    tidx = tpn.BruteForce.euclidean(pts, device="cpu")
    for k, scheme in ((10, "bcap"), (100, "capped"), (200, "capped")):
        _compare(pts, qs, k, jidx, tidx)
        assert (tidx.last_backend, tidx.last_scheme) == ("kernel", scheme)
    # below serving scale bcap ends; n >= 200 k_scan keeps capped
    assert tbf.pick_scheme(10, n - 1) == "capped"


def test_capped_route_never_returns_seeded_nan_rows(monkeypatch):
    """NaN rows among the first k_scan rows seed the capped working set at
    +inf; with one pass per tile some survive to the rescore, whose direct
    form would score their zeroed copies at the centroid's distance.  The
    route drops them (the JAX route returns them here), and stays exact."""
    rng = np.random.default_rng(10)
    n, d, k = 4096, 32, 10
    pts = (rng.standard_normal((n, d)) * 3 + 5).astype(np.float32)
    qs = (rng.standard_normal((N_Q, d)) * 3 + 5).astype(np.float32)
    pts[:18] = np.nan
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    monkeypatch.setattr(tbf, "CAPPED_TILE", 512)
    monkeypatch.setattr(tbf, "capped_passes", lambda *a: 1)
    td, ti = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), k, n, mu,
                               scheme="capped")
    assert (ti.numpy() >= 18).all()
    od, oi = _oracle(pts, qs, k)
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-4, atol=1e-4)


# ---- the large-k path: merge, capped from k_scan 512, the row sorts -------

def _reference_scheme(k_eff, n, tn=4096):
    """The JAX package's automatic scheme (ops/bruteforce.py:638-663, with
    bcap planes, not fast) and the passes its capped branch would run
    (:922-928), written out independently of the port."""
    ks = min(k_eff + 8, n)
    if ks <= 32 and n >= 262144:
        return "bcap", None
    if ks <= 128 and n >= 262144:
        scheme = "capped"
    elif (ks <= min(1024, tn) or 3072 <= ks <= min(4088, tn)) \
            and n >= 200 * ks:
        scheme = "capped"
    else:
        return ("fold" if k_eff + 8 <= 640 else "merge"), None
    k_scan = ks
    if k_scan > 1024:
        k_scan = max(min(-(-k_scan // 128) * 128, 4096), k_eff)
    lam = k_scan * tn / n
    if k_scan <= 32 and lam <= 0.5:
        passes = 2
    elif k_scan <= 128 and lam <= 2.0:
        passes = 4
    else:
        passes = min(48, int(np.ceil(lam + 3.0 * np.sqrt(lam) + 2.0)))
    return scheme, (passes, k_scan)


@pytest.mark.parametrize("k,n", [
    (10, 10 ** 6), (100, 10 ** 6), (200, 10 ** 6), (1000, 10 ** 6),
    (2000, 10 ** 6), (3000, 10 ** 6), (3070, 10 ** 6), (4080, 10 ** 7),
    (1000, 300000), (500, 150000), (500, 10 ** 6), (10, 262143),
    (10, 3000), (700, 5000), (4088, 4100), (1, 1)])
def test_pick_scheme_follows_reference(k, n):
    """The reference's route, except deviation 1: where its capped branch
    needs more than 15 passes or k_scan > 1024, the port takes fold or
    merge."""
    want, capped = _reference_scheme(k, n)
    got = tbf.pick_scheme(k, n)
    if capped is not None and (capped[0] > tbf.PASSES_MAX
                               or capped[1] > 1024):
        assert got == ("fold" if k + 8 <= 640 else "merge"), (k, n)
    else:
        assert got == want, (k, n)


def test_deviation_one_cases():
    """The slice's shapes at 1M rows, and the rows of deviation 1."""
    n = 10 ** 6
    assert [tbf.pick_scheme(k, n) for k in (200, 1000, 2000, 3000)] == [
        "capped", "capped", "merge", "merge"]
    assert tbf.capped_passes(1008, tbf.CAPPED_TILE, n, "capped") == 13
    # the reference takes capped at 26 passes here, the port merge
    assert _reference_scheme(3070, n) == ("capped", (26, 3200))
    assert tbf.pick_scheme(3070, n) == "merge"
    assert tbf.pick_scheme(1000, 300000) == "merge"     # 27 passes
    assert tbf.pick_scheme(500, 150000) == "fold"       # 28 passes
    assert [tbf.scan_width("merge", k, n) for k in (1017, 2000, 3000, 4088)] \
        == [1152, 2048, 3072, 4096]
    assert tbf.scan_width("capped", 1000, n) == 1008
    assert tbf.scan_width("merge", 1090, 1100) == 1152
    assert tbf.scan_width("fold", 1000, 1005) == 1005


@pytest.mark.parametrize("scheme,k,width_sort", [
    ("merge", 1500, "bitonic"), ("merge", 2100, "rank"),
    ("capped", 600, "bitonic")])
def test_forced_large_k_routes_match_jax(scheme, k, width_sort, monkeypatch):
    """The port's route with the scheme forced against the JAX route at
    "highest" (interpret mode) on the same padded index, both against the
    f64 oracle: merge at k_scan 1536 and 2176, capped at k_scan 608 (most
    queries repaired at 15 passes).  Both re-rank through _rescore_large,
    on the bitonic sort up to width 2048 and the rank sort above."""
    rng = np.random.default_rng(k)
    n, d = 8192, 32
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((N_Q, d)).astype(np.float32)
    pts[[7, 4000]] = np.nan
    qs[3] = np.nan
    mu = jbf.center_of(jnp.asarray(pts))
    pp, pn = jbf.pad_for_pallas(jnp.asarray(pts) - mu, tn=2048)
    jd, ji = (np.asarray(a) for a in jbf.knn_pallas_prepadded(
        pp, pn, jnp.asarray(qs), k, n, mu, precision="highest",
        scheme=scheme, tn=2048, interpret=True))
    sorts = []
    for name in ("bitonic_sort_pairs", "rank_sort_pairs"):
        fn = getattr(tbf, name)
        monkeypatch.setattr(tbf, name, lambda *a, _f=fn, _n=name:
                            sorts.append((_n, a[0].shape[1])) or _f(*a))
    td, ti = (t.numpy() for t in tbf.knn_prepadded(
        torch.from_numpy(np.array(pp)), torch.from_numpy(np.array(pn)),
        torch.from_numpy(qs), k, n, torch.from_numpy(np.array(mu)),
        scheme=scheme))
    assert sorts and sorts[0][0].startswith(width_sort)
    od, oi = _oracle(pts, qs, k)
    nanq = np.isnan(qs).any(axis=1)
    assert td.shape == (N_Q, k)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    np.testing.assert_allclose(td[~nanq], od[~nanq], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td[~nanq], jd[~nanq], rtol=1e-4, atol=1e-4)
    for r in np.flatnonzero(~nanq):
        if not _tied(pts, qs[r].astype(np.float64), k):
            assert set(ti[r].tolist()) == set(oi[r].tolist()), r
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r


def test_rescore_large_matches_rescore_exact():
    """_rescore_large (chunked gather, row-sort re-rank) gives rescore_exact's
    answer on both sides of the bitonic / rank cutover, missing and
    out-of-range ids included."""
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.standard_normal((3000, 16)).astype(np.float32))
    pts[5] = float("nan")
    qs = torch.from_numpy(rng.standard_normal((70, 16)).astype(np.float32))
    for width in (600, 2100):
        idx = torch.from_numpy(rng.integers(-5, 3005, (70, width))
                               .astype(np.int32))
        idx[:, 0] = 5
        got = tbf._rescore_large(pts, qs, idx, 550)
        want = tbf.rescore_exact(pts, qs, idx, 550)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [1017, 2000])
def test_large_k_kernel_route_matches_jax(k):
    """k + 8 > 1024 rides the kernel route (merge) end to end and answers
    as the JAX BruteForce does."""
    pts, qs = _data(5000, 64, np.float32, seed=12, nan_rows=(3,),
                    nan_queries=(1,))
    jidx = jpn.BruteForce.euclidean(pts)
    tidx = tpn.BruteForce.euclidean(pts, device="cpu")
    _compare(pts, qs, k, jidx, tidx)
    assert (tidx.last_backend, tidx.last_scheme) == ("kernel", "merge")


# ---- the opt-in schemes: fold_lazy, two_phase, bcap2 ----------------------

def _padded(pts):
    """The JAX package's centred index padded to 2048 rows, as the JAX
    route's own tests build it."""
    mu = jbf.center_of(jnp.asarray(pts))
    pp, pn = jbf.pad_for_pallas(jnp.asarray(pts) - mu, tn=2048)
    return mu, pp, pn


def _jax_route(scheme, pts, qs, k, mu, pp, pn):
    """knn_pallas_prepadded at "highest" in interpret mode; bcap and bcap2
    read planes interleaved at a 2048-row granule, whose blocks are the
    port's 16 contiguous rows."""
    kw = dict(precision="highest", interpret=True, scheme=scheme, tn=2048)
    if scheme in ("bcap", "bcap2"):
        from petal_neighbors_tpu.ops.pallas.knn_kernel import (
            prepare_bcap_planes)
        kw.update(bcap_tn=2048, bcap_planes=prepare_bcap_planes(
            pp, pn, tn=2048, precision="highest"))
    return [np.asarray(a) for a in jbf.knn_pallas_prepadded(
        pp, pn, jnp.asarray(qs), k, len(pts), mu, **kw)]


def _port_route(scheme, pts, qs, k, mu, pp, pn):
    return [t.numpy() for t in tbf.knn_prepadded(
        torch.from_numpy(np.array(pp)), torch.from_numpy(np.array(pn)),
        torch.from_numpy(qs), k, len(pts), torch.from_numpy(np.array(mu)),
        scheme=scheme)]


def _check_exact(pts, qs, k, td, ti, jd=None, ji=None):
    """Against the f64 oracle (and the JAX route where given): distances
    within rtol/atol 1e-4 (direct forms on differently centred copies),
    ids as sets off f32 ties, NaN queries (+inf, -1)."""
    od, oi = _oracle(pts, qs, k)
    nanq = np.isnan(qs).any(axis=1)
    assert td.shape == (len(qs), k) and ti.dtype == np.int32
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    np.testing.assert_allclose(td[~nanq], od[~nanq], rtol=1e-4, atol=1e-4)
    if jd is not None:
        np.testing.assert_allclose(td[~nanq], jd[~nanq], rtol=1e-4, atol=1e-4)
        assert (ji[nanq] == -1).all()
    for r in np.flatnonzero(~nanq):
        if not _tied(pts, qs[r].astype(np.float64), k):
            assert set(ti[r].tolist()) == set(oi[r].tolist()), r
            if ji is not None:
                assert set(ti[r].tolist()) == set(ji[r].tolist()), r


@pytest.mark.parametrize("scheme", ["fold_lazy", "two_phase", "bcap2"])
@pytest.mark.parametrize("k", [10, 40])
def test_opt_in_schemes_match_jax(scheme, k):
    """knn_prepadded(scheme=...) against the JAX route on the same padded
    index, both against the f64 oracle, NaN rows and queries included."""
    rng = np.random.default_rng(30 + k)
    pts = rng.standard_normal((8192, 32)).astype(np.float32)
    qs = rng.standard_normal((N_Q, 32)).astype(np.float32)
    pts[[7, 4000]] = np.nan
    qs[3] = np.nan
    mu, pp, pn = _padded(pts)
    jd, ji = _jax_route(scheme, pts, qs, k, mu, pp, pn)
    td, ti = _port_route(scheme, pts, qs, k, mu, pp, pn)
    _check_exact(pts, qs, k, td, ti, jd, ji)


@pytest.mark.parametrize("scheme", ["bcap", "bcap2"])
def test_bcap_large_k_rescore_matches_jax(scheme, monkeypatch):
    """k * 16 > 1024 (k=80: 88 blocks, 1408 candidate rows) takes the
    large-k rescore in both packages: the bisection cutoff, the compaction
    into 256 lanes and the bitonic sort; forced bcap too, as the reference
    does."""
    rng = np.random.default_rng(31)
    pts = rng.standard_normal((8192, 16)).astype(np.float32)
    qs = rng.standard_normal((N_Q, 16)).astype(np.float32)
    pts[[5, 6000]] = np.nan
    qs[9] = np.nan
    mu, pp, pn = _padded(pts)
    jd, ji = _jax_route(scheme, pts, qs, 80, mu, pp, pn)
    widths = []
    sort = tbf.bitonic_sort_pairs
    monkeypatch.setattr(tbf, "bitonic_sort_pairs", lambda k_, v_: widths.append(
        k_.shape[1]) or sort(k_, v_))
    td, ti = _port_route(scheme, pts, qs, 80, mu, pp, pn)
    assert widths[0] == 256
    _check_exact(pts, qs, 80, td, ti, jd, ji)


def test_bcap2_large_k_on_the_rank_sort(monkeypatch):
    """k=1990: 512 blocks cover all 8192 rows, and the compaction's 2176
    lanes go to the rank sort; exact against the f64 oracle."""
    rng = np.random.default_rng(32)
    pts = rng.standard_normal((8192, 8)).astype(np.float32)
    qs = rng.standard_normal((6, 8)).astype(np.float32)
    pts[100] = np.nan
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    widths = []
    sort = tbf.rank_sort_pairs
    monkeypatch.setattr(tbf, "rank_sort_pairs", lambda k_, v_: widths.append(
        k_.shape[1]) or sort(k_, v_))
    td, ti = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), 1990, 8192, mu,
                               scheme="bcap2")
    assert widths == [2176]
    od, oi = _oracle(pts, qs, 1990)
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-4, atol=1e-4)
    for r in range(len(qs)):
        if not _tied(pts, qs[r].astype(np.float64), 1990):
            assert set(ti[r].tolist()) == set(oi[r].tolist())


@pytest.mark.parametrize("k", [10, 20])
def test_bcap2_k_up_to_n(k):
    """n = 20 rows, one padded 64-row index: every block is a candidate;
    the ids are the oracle's in order (as the JAX package's test)."""
    rng = np.random.default_rng(33)
    pts = rng.standard_normal((20, 8)).astype(np.float32)
    qs = rng.standard_normal((N_Q, 8)).astype(np.float32)
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    td, ti = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), k, 20, mu,
                               scheme="bcap2")
    od, oi = _oracle(pts, qs, k)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-5, atol=1e-5)


def test_bcap2_all_ties_repair(monkeypatch):
    """An all-identical corpus: every block minimum equals the k-th
    rescored value, the proof cannot certify, the repair answers every
    query, and the result stays exact (distance 0, k distinct ids)."""
    rng = np.random.default_rng(34)
    pts = np.broadcast_to(rng.standard_normal((1, 8)).astype(np.float32),
                          (4096, 8)).copy()
    qs = np.broadcast_to(pts[0], (N_Q, 8)).copy()
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    folds = []
    fold = tbf.knn_fold
    monkeypatch.setattr(tbf, "knn_fold", lambda *a, **kw: folds.append(
        len(a[1])) or fold(*a, **kw))
    td, ti = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), 5, 4096, mu,
                               scheme="bcap2")
    assert folds == [N_Q]
    assert (td.numpy() == 0).all()
    for row in ti.tolist():
        assert len(set(row)) == 5 and all(0 <= x < 4096 for x in row)


def test_two_phase_fallback_or_not(monkeypatch):
    """Random points put the 10 nearest in 10 different subchunks for most
    queries, so the proof fails and the whole batch re-runs the fold
    route; with every point duplicated beside itself, two of the 10
    nearest share a subchunk and every query is covered.  Both answers are
    exact and agree with the JAX route."""
    rng = np.random.default_rng(35)
    folds = []
    fold = tbf.knn_fold
    monkeypatch.setattr(tbf, "knn_fold", lambda *a, **kw: folds.append(
        len(a[1])) or fold(*a, **kw))
    for paired, want in ((False, True), (True, False)):
        pts = rng.standard_normal((8192, 16)).astype(np.float32)
        if paired:
            pts[1::2] = pts[0::2]
        qs = rng.standard_normal((N_Q, 16)).astype(np.float32)
        pts[7] = np.nan
        qs[4] = np.nan
        mu, pp, pn = _padded(pts)
        folds.clear()
        td, ti = _port_route("two_phase", pts, qs, 10, mu, pp, pn)
        assert tbf.last_two_phase_fallback is want
        assert folds == ([N_Q] if want else [])
        jd, ji = _jax_route("two_phase", pts, qs, 10, mu, pp, pn)
        _check_exact(pts, qs, 10, td, ti, jd, ji)


def test_fold_lazy_route_limits():
    """fold_lazy keeps at most 1024 candidates, as the reference's kernel
    asserts; it answers as fold does below that."""
    pts, qs = _data(3000, 40, np.float32, seed=36, nan_rows=(4,),
                    nan_queries=(2,))
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    with pytest.raises(ValueError, match="fold_lazy"):
        tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), 1017, 3000, mu,
                          scheme="fold_lazy")
    lazy = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), 1016, 3000, mu,
                             scheme="fold_lazy")
    fold = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), 1016, 3000, mu,
                             scheme="fold")
    assert torch.equal(lazy[0], fold[0]) and torch.equal(lazy[1], fold[1])


# ---- the generic-metric path: the Lp kernel, cosine through the kernels --

GEN_N, GEN_D = 4608, 48

#: (name, JAX metric, port metric) on the Lp route
LP_METRICS = {
    "minkowski3": (jpn.Minkowski(3.0), tpn.Minkowski(3.0)),
    "manhattan": (jpn.Manhattan(), tpn.Manhattan()),
    "chebyshev": (jpn.Chebyshev(), tpn.Chebyshev()),
}


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX BruteForce's Lp and cosine kernel routes, run as its own
    tests run them (tests/test_bruteforce.py:330-353, :584-605): Pallas in
    interpret mode on the CPU."""
    from functools import partial

    import petal_neighbors_tpu.ops.pallas.knn_kernel as jkk
    monkeypatch.setattr(jkk, "pallas_available", lambda: True)
    monkeypatch.setattr(jbf, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jbf, "knn_pallas_prepadded", partial(
        jbf.knn_pallas_prepadded.__wrapped__, interpret=True))


def _gen_data(seed, n=GEN_N, d=GEN_D):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((N_Q, d)).astype(np.float32)
    pts[11] = np.nan
    pts[40, 3] = np.nan
    qs[2] = np.nan
    return pts, qs


def _f64_dists(metric, pts, q):
    """Every point's f64 distance to q under the port's metric, NaN as
    +inf."""
    d = metric.dist(torch.from_numpy(q.astype(np.float64))[None],
                    torch.from_numpy(pts.astype(np.float64)))[0].numpy()
    return np.where(np.isnan(d), np.inf, d)


def _compare_generic(metric, pts, qs, k, jd, ji, td, ti, tol=1e-5):
    """Distances within tol; NaN queries (+inf, -1); ids equal as sets
    where the f64 k-th and (k+1)-th distances are apart."""
    jd, ji, td, ti = (np.asarray(a) for a in (jd, ji, td, ti))
    assert td.shape == jd.shape == (len(qs), min(k, len(pts)))
    np.testing.assert_allclose(td, jd, rtol=tol, atol=tol)
    with np.errstate(invalid="ignore"):          # inf - inf in the tails
        assert (np.diff(td, axis=1)[np.isfinite(td[:, 1:])] >= 0).all()
    bad = metric.invalid_queries(torch.from_numpy(qs)).numpy()
    assert (ti[bad] == -1).all() and np.isposinf(td[bad]).all()
    for r in np.flatnonzero(~bad):
        d = np.sort(_f64_dists(metric, pts, qs[r]))
        if k < len(d) and d[k] - d[k - 1] <= 1e-5 * max(d[k], 1e-12):
            continue
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r


@pytest.mark.parametrize("name", list(LP_METRICS))
def test_lp_route_matches_jax(name, jax_kernels):
    """Minkowski-3, Manhattan and Chebyshev at d > 32 and n >= 4096 take
    the Lp kernel route in both packages and answer alike; NaN rows are
    never returned."""
    jm, tm = LP_METRICS[name]
    pts, qs = _gen_data(20)
    jidx = jpn.BruteForce(pts, jm)
    tidx = tpn.BruteForce(pts, tm, device="cpu")
    assert jidx._lp_spec is not None
    for k in (1, 7, 100):
        jd, ji = jidx.query_batch(qs, k)
        assert jidx.last_backend == "pallas"
        td, ti = tidx.query_batch(qs, k)
        assert (tidx.last_backend, tidx.last_scheme) == ("kernel", "lp")
        assert td.dtype == torch.float32 and ti.dtype == torch.int32
        _compare_generic(tm, pts, qs, k, jd, ji, td, ti)
        assert not np.isin(ti.numpy(), [11, 40]).any()
    i, d = tidx.query(qs[0], 3)
    assert i.tolist() == tidx.query_batch(qs[:1], 3)[1][0].tolist()
    assert tidx.query_nearest(pts[17]) == (17, 0.0)


def test_cosine_route_matches_jax(jax_kernels):
    """Cosine at d > 32 and n >= 4096 rides the Euclidean kernels on the
    normalized copy in both packages; zero-norm and NaN rows are never
    returned, and zero-norm and NaN queries give (+inf, -1)."""
    pts, qs = _gen_data(21)
    pts[5] = 0.0
    qs[7] = 0.0
    jidx = jpn.BruteForce(pts, jpn.Cosine())
    tidx = tpn.BruteForce(pts, "cosine", device="cpu")
    assert jidx._cosine_kernel and tidx._cosine
    for k in (1, 5, 40):
        jd, ji = jidx.query_batch(qs, k)
        assert jidx.last_backend == "pallas"
        td, ti = tidx.query_batch(qs, k)
        assert tidx.last_backend == "kernel"
        assert tidx.last_scheme in ("fold", "capped")
        _compare_generic(tpn.Cosine(), pts, qs, k, jd, ji, td, ti, tol=2e-6)
        assert not np.isin(ti.numpy(), [5, 11, 40]).any()
        # against the f64 oracle
        for r in (0, 1, 3):
            want = np.sort(_f64_dists(tpn.Cosine(), pts, qs[r]))[:k]
            np.testing.assert_allclose(td[r].numpy(), want, atol=2e-6)
    assert (ti[7] == -1).all() and np.isposinf(td[7].numpy()).all()


def test_generic_scan_routes_match_jax():
    """Haversine, low-d Minkowski, small corpora and f64 Lp take the scan
    and answer as the JAX XLA path."""
    rng = np.random.default_rng(22)
    lat = rng.uniform(-1.5, 1.5, (500, 1))
    lon = rng.uniform(-3.1, 3.1, (500, 1))
    geo = np.concatenate([lat, lon], 1).astype(np.float32)
    geo[9] = np.nan
    cases = [(tpn.Haversine(), jpn.Haversine(), geo, geo[:N_Q] + 0.01),
             (tpn.Minkowski(3.0), jpn.Minkowski(3.0)) + _gen_data(23, d=8),
             (tpn.Chebyshev(), jpn.Chebyshev()) + _gen_data(24, n=3000),
             (tpn.Cosine(), jpn.Cosine()) + _gen_data(25, n=3000),
             (tpn.Manhattan(), jpn.Manhattan()) + tuple(
                 a.astype(np.float64) for a in _gen_data(26, n=700))]
    for tm, jm, pts, qs in cases:
        tidx = tpn.BruteForce(pts, tm, device="cpu")
        jidx = jpn.BruteForce(pts, jm)
        for k in (1, 10):
            jd, ji = jidx.query_batch(qs, k)
            td, ti = tidx.query_batch(qs, k)
            assert (tidx.last_backend, tidx.last_scheme) == ("scan", None)
            tol = 1e-10 if pts.dtype == np.float64 else 1e-5
            _compare_generic(tm, pts, qs, k, jd, ji, td, ti, tol=tol)


def test_lp_k_beyond_the_kernel_takes_the_scan():
    """k > 4096 leaves the Lp kernel for the scan over the index's own
    NaN-zeroed copy and its invalid mask, as the JAX index does."""
    pts, qs = _gen_data(27, d=40)
    qs = qs[:6]
    tidx = tpn.BruteForce(pts, tpn.Minkowski(3.0), device="cpu")
    td, ti = tidx.query_batch(qs, 4100)
    assert (tidx.last_backend, tidx.last_scheme) == ("scan", None)
    jd, ji = jbf.knn(pts, qs, 4100, jpn.Minkowski(3.0), backend="xla")
    _compare_generic(tpn.Minkowski(3.0), pts, qs, 4100, jd, ji, td, ti)
    assert not np.isin(ti.numpy(), [11, 40]).any()
    tidx.query_batch(qs, 4096)
    assert (tidx.last_backend, tidx.last_scheme) == ("kernel", "lp")


def _reference_with_bcap(n, d, cosine=False):
    """The JAX index's bcap planes, written out from
    trees/bruteforce.py:93-118: cosine indexes have none; otherwise
    with_split = n*d <= SPLIT_BUDGET_ELEMS and with_bcap = with_split and
    n >= 262144."""
    with_split = n * d <= jpn.BruteForce.SPLIT_BUDGET_ELEMS
    return not cosine and with_split and n >= 262144


@pytest.mark.parametrize("n,d,cosine,want", [
    (10 ** 6, 128, False, "bcap"), (10 ** 6, 960, False, "capped"),
    (10 ** 6, 128, True, "capped"), (262144, 2048, False, "bcap"),
    (262145, 2048, False, "capped"), (262143, 128, False, "capped")])
def test_pick_scheme_takes_bcap_where_the_reference_has_planes(n, d, cosine,
                                                                want):
    """The route repair: bcap only where the reference's index holds bcap
    planes, so k=10 at the GIST-1M shape (1M x 960) and on a cosine index
    is capped, as the reference serves it."""
    planes = tbf.with_bcap_planes(n, d, cosine)
    assert planes == _reference_with_bcap(n, d, cosine)
    assert tbf.SPLIT_BUDGET_ELEMS == jpn.BruteForce.SPLIT_BUDGET_ELEMS
    assert tbf.pick_scheme(10, n, planes) == want


def test_index_passes_the_bcap_flag(monkeypatch):
    """BruteForce hands pick_scheme its own planes flag: with the cutovers
    scaled down to a 4608-row index, a budget one element short of n*d
    turns k=10 from bcap to capped, and a cosine index never takes bcap."""
    pts, qs = _gen_data(28, d=40)
    monkeypatch.setattr(tbf, "CAPPED_MIN_N", 4096)
    for budget, want in ((GEN_N * 40, "bcap"), (GEN_N * 40 - 1, "capped")):
        monkeypatch.setattr(tbf, "SPLIT_BUDGET_ELEMS", budget)
        idx = tpn.BruteForce.euclidean(pts, device="cpu")
        d, i = idx.query_batch(qs, 10)
        assert idx.last_scheme == want
        assert not np.isin(i.numpy(), [11, 40]).any()
    cos = tpn.BruteForce(pts, "cosine", device="cpu")
    cos.query_batch(qs, 10)
    assert cos.last_scheme == "capped"


def test_bruteforce_from_jax_arrays_lp_and_cosine():
    """The JAX package's Lp and cosine layouts carried across answer as a
    rebuilt index does: the Lp layout bit for bit (the same values through
    the same arithmetic), the cosine one within its normalization's
    rounding."""
    pts, qs = _gen_data(29)
    pts[5] = 0.0
    ppad, mask, bad = jbf.prepare_lp_index(jnp.asarray(pts), 512)
    arrays = dict(points=pts, ppad=np.asarray(ppad), mask=np.asarray(mask),
                  bad=np.asarray(bad))
    for m in (tpn.Minkowski(3.0), tpn.Chebyshev()):
        carried = bruteforce_from_jax_arrays(arrays, metric=m, device="cpu")
        built = tpn.BruteForce(pts, m, device="cpu")
        assert tuple(carried._pts.shape) == ppad.shape
        for k in (1, 10):
            cd, ci = carried.query_batch(qs, k)
            assert (carried.last_backend, carried.last_scheme) == (
                "kernel", "lp")
            bd, bi = built.query_batch(qs, k)
            assert torch.equal(cd, bd) and torch.equal(ci, bi)
        # the scan over the carried copy
        cd, ci = carried.query_batch(qs[:3], 4100)
        bd, bi = built.query_batch(qs[:3], 4100)
        assert carried.last_backend == "scan"
        np.testing.assert_allclose(cd.numpy(), bd.numpy(), rtol=1e-6)
    cpad, cnorm, _, cbad = jbf.prepare_cosine_index(
        jnp.asarray(pts), jbf.pad_granule(GEN_D), with_split=False)
    carried = bruteforce_from_jax_arrays(
        dict(points=pts, ppad=np.asarray(cpad), pnorm=np.asarray(cnorm),
             bad=np.asarray(cbad)), metric="cosine", device="cpu")
    built = tpn.BruteForce(pts, "cosine", device="cpu")
    assert carried._cosine
    for k in (1, 10):
        cd, ci = carried.query_batch(qs, k)
        bd, bi = built.query_batch(qs, k)
        assert carried.last_backend == "kernel"
        _compare_generic(tpn.Cosine(), pts, qs, k, bd, bi, cd, ci, tol=1e-6)
        assert not np.isin(ci.numpy(), [5, 11, 40]).any()
    with pytest.raises(KeyError):
        bruteforce_from_jax_arrays({"points": pts, "ppad": arrays["ppad"],
                                    "bad": arrays["bad"]},
                                   metric="minkowski", device="cpu")
    with pytest.raises(ValueError):
        bruteforce_from_jax_arrays(dict(arrays, mask=arrays["mask"][:7]),
                                   metric=tpn.Manhattan(), device="cpu")
    with pytest.raises(ValueError):
        bruteforce_from_jax_arrays(arrays, metric="haversine", device="cpu")


def test_capped_route_proves_on_the_tc_bound(monkeypatch):
    """The capped route's proof uses the tensor-core tier's bound: a query
    is covered only when its k-th rescored distance is at most thr minus
    that bound, and the answers equal the scan's (exact) on data without
    near ties."""
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(rng.random((8192, 48), dtype=np.float32))
    qs = torch.from_numpy(rng.random((40, 48), dtype=np.float32))
    mu, pp, pn, _ = tbf.prepare_euclidean_index(pts)
    dims = []
    real = tbf.tc_proof_err

    def spy(dim, qn, xn_max):
        dims.append(dim)
        return real(dim, qn, xn_max)
    monkeypatch.setattr(tbf, "tc_proof_err", spy)
    d, i = tbf.knn_prepadded(pp, pn, qs, 10, 8192, mu, scheme="capped")
    assert dims == [48]
    sd, si = tbf.knn(pts - mu, qs - mu, 10)
    assert torch.equal(torch.sort(i, 1).values, torch.sort(si, 1).values)
    np.testing.assert_allclose(d.numpy(), sd.numpy(), rtol=1e-5)


@pytest.mark.parametrize("scheme,tier", [("bcap", "tc"), ("bcap2", "tc"),
                                         ("two_phase", "tc"),
                                         ("capped", "tc")])
def test_proof_gated_routes_prove_on_their_tier(scheme, tier, monkeypatch):
    """Each proof-gated scheme proves on the bound of the product tier that
    made its candidates and thr: bcap, bcap2, capped and two_phase (its
    subchunk minima, the minima of the block minima's tensor-core product)
    all on the tensor-core tier's."""
    rng = np.random.default_rng(40)
    pts = torch.from_numpy(rng.random((8192, 48), dtype=np.float32))
    qs = torch.from_numpy(rng.random((N_Q, 48), dtype=np.float32))
    mu, pp, pn, _ = tbf.prepare_euclidean_index(pts)
    dims = []
    real = tbf.tc_proof_err

    def spy(dim, qn, xn_max):
        dims.append(dim)
        return real(dim, qn, xn_max)
    monkeypatch.setattr(tbf, "tc_proof_err", spy)
    tbf.knn_prepadded(pp, pn, qs, 10, 8192, mu, scheme=scheme)
    assert (tier, dims) == ("tc", [48])


@pytest.mark.parametrize("d", [128, 960])
def test_two_phase_threshold_is_sound_on_the_tc_bound(d):
    """two_phase's threshold T (the k-th smallest subchunk minimum, on the
    tensor-core tier) against the f64 u: every 128-row subchunk outside
    the k selected has its least f64 u at or above T −
    ``tc_proof_err``, so the route's proof on that tier holds."""
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

    rng = np.random.default_rng(43 + d)
    n, nq, k = 4096, 16, 10
    pts = (rng.standard_normal((n, d)) * 10 + 3).astype(np.float32)
    qs = (rng.standard_normal((nq, d)) * 10 + 3).astype(np.float32)
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    qc = torch.from_numpy(qs) - mu
    _, _, thr_u = tbf._two_phase_small_k(pp, pn, qc, k)
    minima = mk.subchunk_minima(pp, qc, pn)
    selected = torch.sort(minima, dim=1, stable=True).indices[:, :k].numpy()
    assert torch.equal(thr_u, torch.sort(minima, dim=1).values[:, k - 1])
    err = tbf.tc_proof_err(d, torch.sum(qc * qc, 1),
                           torch.max(torch.where(torch.isfinite(pn), pn,
                                                 0.0))).numpy()
    p64, q64 = pp.numpy().astype(np.float64), qc.numpy().astype(np.float64)
    xn64 = np.where(np.isfinite(pn.numpy()), (p64 * p64).sum(1), np.inf)
    u64 = xn64[None, :] - 2.0 * q64 @ p64.T
    short = -u64.shape[1] % mk.SUBCHUNK
    u64 = np.pad(u64, ((0, 0), (0, short)), constant_values=np.inf)
    sub64 = u64.reshape(nq, -1, mk.SUBCHUNK).min(2)
    thr = thr_u.numpy()
    for r in range(nq):
        outside = np.setdiff1d(np.arange(sub64.shape[1]), selected[r])
        assert sub64[r, outside].min() >= thr[r] - err[r], r


@pytest.mark.parametrize("scheme", ["bcap", "bcap2"])
@pytest.mark.parametrize("d", [128, 960])
def test_bcap_routes_match_f64_oracle(scheme, d, monkeypatch):
    """bcap and bcap2 end to end on the tensor-core tier (their plain
    versions on ``_u_tc``), proved on its bound and repaired by fold where
    the proof fails, against the f64 oracle: NaN rows never returned, NaN
    queries (+inf, -1), ids as sets off f32 ties."""
    rng = np.random.default_rng(41 + d)
    pts = (rng.standard_normal((8192, d)) * 10 + 3).astype(np.float32)
    qs = (rng.standard_normal((N_Q, d)) * 10 + 3).astype(np.float32)
    pts[[7, 4000, 8191]] = np.nan
    qs[[3, N_Q - 1]] = np.nan
    folds = []
    fold = tbf.knn_fold
    monkeypatch.setattr(tbf, "knn_fold", lambda *a, **kw: folds.append(
        len(a[1])) or fold(*a, **kw))
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    for k in (10, 40):
        td, ti = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), k, 8192,
                                   mu, scheme=scheme)
        td, ti = td.numpy(), ti.numpy()
        assert not np.isin(ti, [7, 4000, 8191]).any()
        _check_exact(pts, qs, k, td, ti)
    # a repair, where one ran, carried only uncovered queries
    assert all(0 < f < N_Q for f in folds)
