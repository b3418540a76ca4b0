"""The port's radius family (``ops.bruteforce`` and
``BruteForce.query_radius*``) against the JAX package's, on shared numpy
inputs, on the CPU.

Tolerance: masks, counts and id lists are equal, except for pairs whose
f64 reduced distance lies within 2 ulp (of the compute dtype) of the
reduced radius: there two equally correct f32 reduction orders may decide
differently (PARITY.md, "Radius boundary within rounding").  Distances
from ``distances_at`` agree within rtol 1e-6 (f32) and 1e-12 (f64)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.distance import get_metric as jax_metric
from petal_neighbors_tpu.ops import bruteforce as jbf
from petal_neighbors_tpu_torch.convert import bruteforce_from_jax_arrays
from petal_neighbors_tpu_torch.ops import bruteforce as tbf

JAX_METRICS = {"euclidean": jpn.Euclidean(), "manhattan": jpn.Manhattan(),
               "minkowski3": jpn.Minkowski(3.0), "cosine": jpn.Cosine(),
               "chebyshev": jpn.Chebyshev()}
PORT_METRICS = {"euclidean": tpn.Euclidean(), "manhattan": tpn.Manhattan(),
                "minkowski3": tpn.Minkowski(3.0), "cosine": tpn.Cosine(),
                "chebyshev": tpn.Chebyshev()}


def _data(n, d, dtype, q=16, seed=0, nan_rows=(3,), nan_queries=(1,)):
    rng = np.random.default_rng(seed + 7 * n + d)
    pts = rng.normal(size=(n, d)).astype(dtype)
    qs = rng.normal(size=(q, d)).astype(dtype)
    pts[list(nan_rows), 0] = np.nan
    qs[list(nan_queries), -1] = np.nan
    pts[5] = pts[6]                     # a duplicated row
    return pts, qs


def _rd64(name, pts, qs):
    """(Q, n) reduced distances in f64, NaN -> +inf."""
    p, q = pts.astype(np.float64), qs.astype(np.float64)
    diff = q[:, None, :] - p[None, :, :]
    if name == "euclidean":
        rd = (diff ** 2).sum(-1)
    elif name == "manhattan":
        rd = np.abs(diff).sum(-1)
    elif name == "minkowski3":
        rd = (np.abs(diff) ** 3).sum(-1)
    elif name == "chebyshev":
        rd = np.abs(diff).max(-1)
    else:
        rd = 1.0 - (q @ p.T) / (np.linalg.norm(q, axis=1)[:, None]
                               * np.linalg.norm(p, axis=1)[None, :])
    return np.where(np.isnan(rd), np.inf, rd)


def _rr(name, r):
    return {"euclidean": r * r, "minkowski3": r ** 3}.get(name, r)


def _near_boundary(name, pts, qs, r, dtype):
    """(Q, n) bool: pairs within 2 ulp of the reduced radius."""
    rr = _rr(name, float(r))
    ulp = float(np.spacing(dtype(abs(rr) + 1e-30)))
    return np.abs(_rd64(name, pts, qs) - rr) <= 2.0 * ulp + 1e-300


def assert_masks_match(a, b, near):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == bool
    off = a != b
    assert not (off & ~near).any(), np.argwhere(off & ~near)[:5]


def _radius(name, pts, qs, frac=0.05):
    """A radius near the ``frac`` quantile of the finite distances."""
    rd = _rd64(name, pts, qs)
    rd = rd[np.isfinite(rd)]
    rr = float(np.quantile(rd, frac))
    return {"euclidean": np.sqrt(rr), "minkowski3": rr ** (1 / 3)}.get(
        name, rr)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name,d,dtype", [
    ("euclidean", 3, np.float32), ("euclidean", 3, np.float64),
    ("euclidean", 40, np.float32), ("manhattan", 5, np.float32),
    ("minkowski3", 4, np.float64), ("cosine", 6, np.float32),
    ("chebyshev", 3, np.float64)])
@pytest.mark.parametrize("inclusive", [True, False])
def test_radius_mask_direct_form(name, d, dtype, inclusive):
    pts, qs = _data(300, d, dtype)
    r = _radius(name, pts, qs)
    inv = np.zeros(300, bool)
    inv[[7, 8]] = True
    jm = jbf.radius_mask(pts, qs, r, JAX_METRICS[name], inclusive=inclusive,
                         invalid=jnp.asarray(inv), chunk=128)
    tm = tbf.radius_mask(_t(pts), _t(qs), r, PORT_METRICS[name],
                         inclusive=inclusive, invalid=_t(inv), chunk=128)
    assert tm.any() and not tm[:, [3, 7, 8]].any() and not tm[1].any()
    assert_masks_match(jm, tm.numpy(), _near_boundary(name, pts, qs, r,
                                                      dtype))
    # the counts of the mask
    np.testing.assert_array_equal(np.asarray(jbf.radius_counts(jm)),
                                  tbf.radius_counts(tm).numpy())


def test_radius_mask_exact_boundary_rules():
    # binary-exact coordinates: d == r exactly for point 1
    pts = np.array([[0.0], [1.0], [2.5]], np.float32)
    qs = np.array([[0.0]], np.float32)
    for inclusive, want in ((True, [True, True, False]),
                            (False, [True, False, False])):
        tm = tbf.radius_mask(_t(pts), _t(qs), 1.0, inclusive=inclusive)
        jm = jbf.radius_mask(pts, qs, 1.0, inclusive=inclusive)
        assert tm[0].tolist() == want == np.asarray(jm)[0].tolist()


def _count_band_calls(monkeypatch):
    calls = []
    orig = tbf._radius_mask_matmul

    def counted(*a, **kw):
        calls.append(kw["cap"])
        return orig(*a, **kw)
    monkeypatch.setattr(tbf, "_radius_mask_matmul", counted)
    return calls


@pytest.mark.parametrize("inclusive", [True, False])
def test_radius_mask_band_form(inclusive, monkeypatch):
    """f32 Euclidean at d = 64, n = 4096: the matmul band form, with the
    ambiguous pairs rescored in the direct form."""
    pts, qs = _data(4096, 64, np.float32, q=24)
    pts += 3.0
    qs += 3.0
    r = _radius("euclidean", pts, qs, 0.02)
    calls = _count_band_calls(monkeypatch)
    jm = jbf.radius_mask(pts, qs, r, inclusive=inclusive)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tm = tbf.radius_mask(_t(pts), _t(qs), r, inclusive=inclusive)
    assert calls == [256]
    assert tm.sum() > 1000
    near = _near_boundary("euclidean", pts, qs, r, np.float32)
    assert_masks_match(jm, tm.numpy(), near)
    # the band form agrees with the port's own direct form too
    rr = torch.tensor(r, dtype=torch.float32) ** 2
    direct = tbf._member_chunk(_t(pts), _t(qs), rr, tpn.Euclidean(),
                               inclusive)
    assert_masks_match(direct.numpy(), tm.numpy(), near)


def test_radius_mask_band_overflow_falls_back(monkeypatch):
    """More than ``amb_cap`` points of a query in the band: the direct
    form runs again, with the same RuntimeWarning as the JAX package."""
    pts, qs = _data(4096, 64, np.float32, q=4, nan_queries=())
    pts[100:140] = pts[99]               # 41 copies at one distance
    r = float(np.sqrt(((qs[0].astype(np.float64) - pts[99]) ** 2).sum()))
    calls = _count_band_calls(monkeypatch)
    with pytest.warns(RuntimeWarning, match="error band"):
        jm = jbf.radius_mask(pts, qs, r, amb_cap=8)
    with pytest.warns(RuntimeWarning, match="error band"):
        tm = tbf.radius_mask(_t(pts), _t(qs), r, amb_cap=8)
    assert calls == [8]
    assert_masks_match(jm, tm.numpy(),
                       _near_boundary("euclidean", pts, qs, r, np.float32))
    # and the direct form decides the 41 copies alike
    assert len(set(tm[0, 99:140].tolist())) == 1


@pytest.mark.parametrize("name,d,dtype", [
    ("euclidean", 3, np.float32), ("euclidean", 40, np.float64),
    ("manhattan", 4, np.float32), ("cosine", 5, np.float64)])
def test_streaming_counts_and_capped(name, d, dtype):
    pts, qs = _data(400, d, dtype)
    r = _radius(name, pts, qs, 0.08)
    inv = np.zeros(400, bool)
    inv[9] = True
    jmet, tmet = JAX_METRICS[name], PORT_METRICS[name]
    near = _near_boundary(name, pts, qs, r, dtype)
    exact_rows = ~near.any(axis=1)
    for inclusive in (True, False):
        jc = np.asarray(jbf.radius_counts_streaming(
            pts, qs, r, jmet, inclusive=inclusive, invalid=jnp.asarray(inv),
            chunk=96))
        tc = tbf.radius_counts_streaming(_t(pts), _t(qs), r, tmet,
                                         inclusive=inclusive, invalid=_t(inv),
                                         chunk=96).numpy()
        assert tc.dtype == np.int32
        np.testing.assert_array_equal(jc[exact_rows], tc[exact_rows])
        assert (np.abs(jc - tc) <= near.sum(axis=1)).all()
        for cap in (4, 64, 1000):
            ji, jn = (np.asarray(a) for a in jbf.radius_capped(
                pts, qs, r, jmet, cap=cap, inclusive=inclusive,
                invalid=jnp.asarray(inv), chunk=96))
            ti, tn = (a.numpy() for a in tbf.radius_capped(
                _t(pts), _t(qs), r, tmet, cap=cap, inclusive=inclusive,
                invalid=_t(inv), chunk=96))
            assert ti.shape == ji.shape == (len(qs), min(cap, 400))
            np.testing.assert_array_equal(tn, tc)
            np.testing.assert_array_equal(ji[exact_rows], ti[exact_rows])
            np.testing.assert_array_equal(jn[exact_rows], tn[exact_rows])
            assert (tn > cap).any() or cap >= 64


@pytest.mark.parametrize("name,dtype", [("euclidean", np.float32),
                                        ("euclidean", np.float64),
                                        ("minkowski3", np.float32),
                                        ("cosine", np.float64),
                                        ("chebyshev", np.float32)])
def test_distances_at(name, dtype):
    pts, qs = _data(200, 6, dtype)
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 205, size=(len(qs), 30)).astype(np.int32)
    ids[:, 0] = 3                       # a NaN row
    jd = np.asarray(jbf.distances_at(pts, qs, jnp.asarray(ids),
                                     JAX_METRICS[name]))
    td = tbf.distances_at(_t(pts), _t(qs), _t(ids), PORT_METRICS[name])
    td = td.numpy()
    assert td.dtype == dtype
    np.testing.assert_array_equal(np.isposinf(jd), np.isposinf(td))
    fin = np.isfinite(jd)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(td[fin], jd[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("cap", [1, 7, 40, 90])
def test_compact_mask(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random((12, 60)) < 0.3
    mask[0] = False
    mask[1] = True
    ji, jc = jbf.compact_mask(jnp.asarray(mask), cap)
    ti, tc = tbf.compact_mask(_t(mask), cap)
    assert ti.dtype == tc.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


def _index_pairs():
    """(name, n, d, dtype, JAX index kwargs): each of the flat index's
    layouts: the Euclidean kernel copy, the scan (f64, low d), the Lp
    and the cosine kernel copies (f32, d > 32, n >= 4096)."""
    return [("euclidean", 500, 40, np.float32),
            ("euclidean", 300, 3, np.float64),
            ("manhattan", 4096, 40, np.float32),
            ("cosine", 4096, 40, np.float32),
            ("minkowski3", 300, 4, np.float64)]


@pytest.mark.parametrize("name,n,d,dtype", _index_pairs())
def test_bruteforce_radius_matches_jax(name, n, d, dtype):
    pts, qs = _data(n, d, dtype, q=12)
    r = _radius(name, pts, qs, 0.01)
    metric = {"minkowski3": "minkowski"}.get(name, name)
    kw = {"p": 3.0} if name == "minkowski3" else {}
    jidx = jpn.BruteForce(pts, jax_metric(metric, **kw))
    tidx = tpn.BruteForce(pts, tpn.get_metric(metric, **kw), device="cpu")
    near = _near_boundary(name, pts, qs, r, dtype)
    exact_rows = ~near.any(axis=1)
    for inclusive in (True, False):
        jm = np.asarray(jidx.query_radius_batch(qs, r, inclusive=inclusive))
        tm = tidx.query_radius_batch(qs, r, inclusive=inclusive).numpy()
        assert tm.sum() > 0 and not tm[:, 3].any() and not tm[1].any()
        assert_masks_match(jm, tm, near)
        jc = np.asarray(jidx.query_radius_count_batch(qs, r,
                                                      inclusive=inclusive))
        tc = tidx.query_radius_count_batch(qs, r, inclusive=inclusive)
        np.testing.assert_array_equal(jc[exact_rows], tc.numpy()[exact_rows])
        np.testing.assert_array_equal(tc.numpy(), tm.sum(axis=1))
        ji, jn = jidx.query_radius_batch(qs, r, cap=5, inclusive=inclusive)
        ti, tn = tidx.query_radius_batch(qs, r, cap=5, inclusive=inclusive)
        np.testing.assert_array_equal(tn.numpy(), tc.numpy())
        np.testing.assert_array_equal(np.asarray(ji)[exact_rows],
                                      ti.numpy()[exact_rows])
    for row in np.flatnonzero(exact_rows)[:2]:
        got = tidx.query_radius(qs[row], r)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jidx.query_radius(qs[row], r))


def test_bruteforce_radius_on_carried_index():
    """An index carried from the JAX package's arrays decides every pair
    on the same resident copy as the JAX radius op on those arrays."""
    pts, qs = _data(600, 48, np.float32, q=10)
    mu, ppad, pnorm, _, bad, _ = jbf.prepare_euclidean_index(
        jnp.asarray(pts), jbf.pad_granule(48), with_split=False,
        with_bcap=False)
    arrays = dict(points=pts, center=np.asarray(mu), ppad=np.asarray(ppad),
                  pnorm=np.asarray(pnorm), bad=np.asarray(bad))
    tidx = bruteforce_from_jax_arrays(arrays, device="cpu")
    r = _radius("euclidean", pts, qs, 0.03)
    jm = jbf.radius_mask(ppad[:600], jnp.asarray(qs) - mu, r, invalid=bad)
    tm = tidx.query_radius_batch(qs, r).numpy()
    assert tm.sum() > 0 and not tm[:, 3].any()
    assert_masks_match(np.asarray(jm), tm,
                       _near_boundary("euclidean", pts, qs, r, np.float32))


def test_bruteforce_radius_errors():
    tidx = tpn.BruteForce.euclidean(np.zeros((5, 3), np.float32),
                                    device="cpu")
    with pytest.raises(ValueError):
        tidx.query_radius_batch(np.zeros((2, 4), np.float32), 1.0)
    with pytest.raises(ValueError):
        tidx.query_radius(np.zeros(4, np.float32), 1.0)
    ids, counts = tidx.query_radius_batch(np.zeros((2, 3), np.float32), 1.0,
                                          cap=9)
    assert ids.shape == (2, 5) and counts.tolist() == [5, 5]
