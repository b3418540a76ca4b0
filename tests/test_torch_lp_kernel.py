"""The Lp kernel's plain version (what ``lp_knn`` runs for CPU tensors)
against the JAX package's ``lp_knn_pallas`` in interpret mode, on the
same seeded inputs, each padded by its own package's ``pad_for_lp``.

Tolerance: rdist within rtol 1e-5 / atol 1e-5 (both sum the same d terms
in float32, in other orders); ids equal wherever the neighbouring rdists
of the row differ by more than that, and the (+inf, -1) slots equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops.pallas import lp_kernel as jlk
from petal_neighbors_tpu_torch.ops.cuda import lp_kernel as tlk

N_Q = 16
TOL = dict(rtol=1e-5, atol=1e-5)

SPECS = {"p1": (1.0, "sum"), "p2.5": (2.5, "sum"), "p3": (3.0, "sum"),
         "p4": (4.0, "sum"), "chebyshev": (1.0, "max")}


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((N_Q, d)).astype(np.float32)
    pts[[2, n // 2]] = np.nan
    pts[5, d // 3] = np.nan
    qs[1] = np.nan
    qs[6, 0] = np.nan
    return pts, qs


def _jax(pts, qs, k, p, reduce):
    pp, mask = jlk.pad_for_lp(jnp.asarray(pts), tn=512)
    d, i = jlk.lp_knn_pallas(pp, mask, jnp.asarray(qs), k=k,
                             spec=jlk.LpSpec(p, reduce), tq=8, tn=512,
                             interpret=True)
    return np.asarray(d), np.asarray(i)


def _port(pts, qs, k, p, reduce):
    pp, mask = tlk.pad_for_lp(torch.from_numpy(pts), tn=64)
    d, i = tlk.lp_knn(pp, mask, torch.from_numpy(qs), k=k,
                      spec=tlk.LpSpec(p, reduce))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    return d.numpy(), i.numpy()


def _assert_same(td, ti, jd, ji):
    assert td.shape == jd.shape
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], **TOL)
    # JAX's fill of a NaN query row reads NaN; both hold -1 there
    np.testing.assert_array_equal(ti[~fin], -1)
    np.testing.assert_array_equal(ji[~fin], -1)
    with np.errstate(invalid="ignore"):          # inf - inf in the tails
        assert (np.diff(td, axis=1)[np.isfinite(td[:, 1:])] >= 0).all()
    for r in np.flatnonzero(fin.any(axis=1)):
        row = jd[r][fin[r]]
        gap = np.diff(row) > TOL["atol"] + TOL["rtol"] * np.abs(row[1:])
        # a slot is pinned when both of its neighbours are apart from it
        left = np.r_[True, gap]
        right = np.r_[gap, True]
        pinned = left & right
        np.testing.assert_array_equal(ti[r][fin[r]][pinned],
                                      ji[r][fin[r]][pinned])


@pytest.mark.parametrize("k", [1, 7, 100])
@pytest.mark.parametrize("spec", list(SPECS))
def test_plain_version_matches_jax(spec, k):
    p, reduce = SPECS[spec]
    pts, qs = _inputs(700, 40, seed=k)
    td, ti = _port(pts, qs, k, p, reduce)
    jd, ji = _jax(pts, qs, k, p, reduce)
    _assert_same(td, ti, jd, ji)
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    assert not np.isin(ti, [2, 350, 5]).any()


@pytest.mark.parametrize("spec", ["p3", "chebyshev"])
def test_k_beyond_the_tile(spec):
    """k = 600, more than a 512-row tile of the TPU kernel."""
    p, reduce = SPECS[spec]
    pts, qs = _inputs(700, 40, seed=3)
    td, ti = _port(pts, qs, 600, p, reduce)
    jd, ji = _jax(pts, qs, 600, p, reduce)
    _assert_same(td, ti, jd, ji)


def test_fewer_finite_rows_than_k():
    """45 finite rows and k = 64: the rest of each row is (+inf, -1)."""
    pts, qs = _inputs(48, 36, seed=4)
    td, ti = _port(pts, qs, 64, 3.0, "sum")
    jd, ji = _jax(pts, qs, 64, 3.0, "sum")
    _assert_same(td, ti, jd, ji)
    live = ~np.isnan(qs).any(axis=1)
    assert (np.isfinite(td[live]).sum(axis=1) == 45).all()
    assert (ti[live][:, 45:] == -1).all()


def test_pad_for_lp_matches_jax():
    pts, _ = _inputs(100, 8, seed=5)
    jp, jm = jlk.pad_for_lp(jnp.asarray(pts), tn=64)
    tp, tm = tlk.pad_for_lp(torch.from_numpy(pts), tn=64)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tp.shape == (128, 8) and np.isposinf(tm.numpy()[100:]).all()


def test_spec_and_checks():
    from petal_neighbors_tpu_torch import distance as td
    assert tlk.lp_spec_for(td.Chebyshev()) == tlk.LpSpec(1.0, "max")
    assert tlk.lp_spec_for(td.Manhattan()) == tlk.LpSpec(1.0)
    assert tlk.lp_spec_for(td.Minkowski(3.0)) == tlk.LpSpec(3.0)
    assert tlk.lp_spec_for(td.Euclidean()) is None
    assert tlk.lp_spec_for(td.Cosine()) is None
    # the kernel's operation per spec: p=1, max, p=3, other integer, real
    assert [tlk.LpSpec(*s).op() for s in ((1.0,), (1.0, "max"), (3.0,),
                                          (4.0,), (2.5,), (65.0,))] == [
        0, 1, 2, 3, 4, 4]
    pp, mask = tlk.pad_for_lp(torch.ones(8, 4), tn=1)
    q = torch.ones(2, 4)
    with pytest.raises(ValueError):
        tlk.lp_knn(pp, mask, q, k=0, spec=tlk.LpSpec(3.0))
    with pytest.raises(ValueError):
        tlk.lp_knn(pp, mask, q, k=4097, spec=tlk.LpSpec(3.0))
    with pytest.raises(TypeError):
        tlk.lp_knn(pp.double(), mask, q, k=1, spec=tlk.LpSpec(3.0))
    with pytest.raises(ValueError):
        tlk.lp_knn(pp, mask[:3], q, k=1, spec=tlk.LpSpec(3.0))
    assert tlk.lp_knn.launches == 0          # the CPU runs the plain version
