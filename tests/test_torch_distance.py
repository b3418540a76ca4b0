"""The port's metrics against the JAX package's, on shared numpy inputs.

Tolerance: rtol 1e-6 in float64 and 1e-5 in float32 (both packages
evaluate the same formulas; sums and products run in other orders), with
an atol of the same size times the values' scale for the terms that
cancel (the matmul form of Euclidean and Cosine, and zero distances).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import petal_neighbors_tpu.distance as jd
import petal_neighbors_tpu_torch as tpn
import petal_neighbors_tpu_torch.distance as td

#: (name, JAX metric, port metric) for every class and parameter form
METRICS = [
    ("euclidean", jd.Euclidean(), td.Euclidean()),
    ("sqeuclidean", jd.SqEuclidean(), td.SqEuclidean()),
    ("cosine", jd.Cosine(), td.Cosine()),
    ("minkowski3", jd.Minkowski(3.0), td.Minkowski(3.0)),
    ("minkowski2.5", jd.Minkowski(2.5), td.Minkowski(2.5)),
    ("minkowski4", jd.Minkowski(4.0), td.Minkowski(4.0)),
    ("manhattan", jd.Manhattan(), td.Manhattan()),
    ("chebyshev", jd.Chebyshev(), td.Chebyshev()),
    ("haversine", jd.Haversine(), td.Haversine()),
]


def _tol(dtype, scale=1.0):
    r = 1e-6 if dtype == np.float64 else 1e-5
    return dict(rtol=r, atol=r * scale)


def _inputs(name, dtype, d, seed=0):
    rng = np.random.default_rng(seed)
    if name == "haversine":
        lat = rng.uniform(-1.5, 1.5, size=(23, 1))
        lon = rng.uniform(-3.1, 3.1, size=(23, 1))
        x = np.concatenate([lat, lon], 1).astype(dtype)
        return x[:7], x[7:]
    x = (rng.standard_normal((23, d)) * 3 + 1).astype(dtype)
    return x[:7], x[7:]


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [5, 40])
@pytest.mark.parametrize("name,jm,tm", METRICS, ids=[m[0] for m in METRICS])
def test_batch_tier_matches_jax(name, jm, tm, d, dtype):
    q, x = _inputs(name, dtype, d)
    want = np.asarray(jm.rdist(jnp.asarray(q), jnp.asarray(x)))
    got = _np(tm.rdist(torch.from_numpy(q), torch.from_numpy(x)))
    assert got.dtype == dtype and got.shape == (7, 16)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, **_tol(dtype, scale))
    want = np.asarray(jm.rowwise_rdist(jnp.asarray(q), jnp.asarray(x[:7])))
    got = _np(tm.rowwise_rdist(torch.from_numpy(q), torch.from_numpy(x[:7])))
    np.testing.assert_allclose(got, want, **_tol(dtype, scale))
    want = np.asarray(jm.dist(jnp.asarray(q), jnp.asarray(x)))
    got = _np(tm.dist(torch.from_numpy(q), torch.from_numpy(x)))
    np.testing.assert_allclose(got, want,
                               **_tol(dtype, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,jm,tm", METRICS, ids=[m[0] for m in METRICS])
def test_pair_tier_and_conversions_match_jax(name, jm, tm, dtype):
    q, x = _inputs(name, dtype, 6, seed=1)
    a, b = q[0], x[0]
    for fn in ("distance", "rdistance"):
        want = float(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tm, fn)(torch.from_numpy(a), torch.from_numpy(b)))
        assert got == pytest.approx(want, rel=_tol(dtype)["rtol"])
    rd = np.abs(q[:, 0]).astype(dtype) + 0.25
    if name == "haversine":
        rd = rd / (rd.max() + 1.0)      # haversine values lie in [0, 1]
    for fn in ("rdistance_to_distance", "distance_to_rdistance"):
        want = np.asarray(getattr(jm, fn)(jnp.asarray(rd)))
        got = _np(getattr(tm, fn)(torch.from_numpy(rd)))
        np.testing.assert_allclose(got, want, **_tol(dtype))
    # the conversions invert each other
    back = _np(tm.distance_to_rdistance(tm.rdistance_to_distance(
        torch.from_numpy(rd))))
    np.testing.assert_allclose(back, rd, rtol=1e-4 if dtype == np.float32
                               else 1e-10)


@pytest.mark.parametrize("name,jm,tm", METRICS, ids=[m[0] for m in METRICS])
def test_attributes_match_jax(name, jm, tm):
    assert tm.translation_invariant == jm.translation_invariant
    assert tm.tree_compatible == jm.tree_compatible
    assert tm.name == jm.name
    assert repr(tm) == repr(jm)
    assert tm == type(tm)(**({"p": tm.p} if type(tm) is td.Minkowski
                             else {}))


def test_cosine_invalid_queries():
    q = np.ones((5, 4), np.float32)
    q[1] = 0.0                       # zero norm: 0/0 against every point
    q[3, 2] = np.nan
    want = np.asarray(jd.Cosine().invalid_queries(jnp.asarray(q)))
    got = _np(td.Cosine().invalid_queries(torch.from_numpy(q)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, True, False, True, False])
    # the base rule takes NaN rows only
    np.testing.assert_array_equal(
        _np(td.Euclidean().invalid_queries(torch.from_numpy(q))),
        [False, False, False, True, False])


def test_invalid_parameters_raise():
    with pytest.raises(ValueError):
        td.Minkowski(0.5)
    with pytest.raises(ValueError):
        td.Haversine().validate_dim(3)
    td.Haversine().validate_dim(2)
    with pytest.raises(ValueError):
        td.Haversine().rdist(torch.zeros(2, 3), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        tpn.BruteForce(np.zeros((10, 3), np.float32), "haversine",
                       device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["euclidean", "cosine", "minkowski3",
                                  "chebyshev"])
def test_pairwise_matches_jax(name, dtype):
    jm, tm = {m[0]: m[1:] for m in METRICS}[name]
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((30, 40)) * 2 + 100).astype(dtype)
    got = _np(td.pairwise(torch.from_numpy(x), tm))
    want = np.asarray(jd.pairwise(jnp.asarray(x), jm))
    assert got.dtype == dtype and got.shape == (30, 30)
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_array_equal(np.diag(got), 0.0)
    # cosine is not centered: 1 − cos cancels at the scale of 1
    scale = 1.0 if name == "cosine" else float(np.abs(want).max())
    np.testing.assert_allclose(got, want, **_tol(dtype, scale))
    for n in (0, 1):
        z = _np(td.pairwise(torch.from_numpy(x[:n]), tm))
        assert z.shape == (n, n) and not z.any()


def test_pairwise_default_is_euclidean():
    x = np.random.default_rng(3).standard_normal((9, 4))
    np.testing.assert_allclose(_np(tpn.pairwise(torch.from_numpy(x))),
                               np.asarray(jd.pairwise(jnp.asarray(x))),
                               rtol=1e-10, atol=1e-10)


def test_registry_matches_jax():
    for name, cls in jd._REGISTRY.items():
        got = tpn.get_metric(name)
        assert type(got).__name__ == cls.__name__, name
        assert type(got) is getattr(td, cls.__name__)
        assert tpn.get_metric(name.upper()) == got
    assert tpn.get_metric("minkowski", p=3.0) == td.Minkowski(3.0)
    m = td.Chebyshev()
    assert tpn.get_metric(m) is m
    with pytest.raises(ValueError):
        tpn.get_metric("nope")
