"""The port's minima kernels (subchunk_minima for two_phase, bcap_minima for
bcap2), as they run on the CPU (their plain PyTorch versions, both on the
tensor-core tier's u, ``_u_tc``), against the JAX kernels in interpret mode
at "highest", against an f64 reduction and against each other.

Tolerance: the minima are u = ‖x‖² − 2·q·x, which both packages sum in
different orders; rtol 1e-4 with atol 1e-3 (the JAX kernels' own test,
tests/test_pallas_kernel.py:288) against each other, and the f32 product's
accumulation bound d·2⁻²³·(‖q‖² + max ‖x‖²) against the f64 reduction.  NaN
queries give NaN minima in both, and all-padding blocks +inf.  A subchunk's
minimum is the minimum of its 8 block minima bit for bit (one u, and min is
exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops.bruteforce import pad_for_pallas as jax_pad
from petal_neighbors_tpu.ops.pallas.knn_kernel import (bcap_minima as
                                                       jax_bcap_minima,
                                                       prepare_bcap_planes,
                                                       subchunk_minima as
                                                       jax_subchunk_minima)
from petal_neighbors_tpu_torch.ops.bruteforce import pad_for_pallas
from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

Q, D = 32, 48


def _inputs(seed, n, d=D):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((Q, d)).astype(np.float32)
    pts[[2, n // 3, n - 1]] = np.nan
    pts[n // 2, d // 2] = np.nan
    qs[[0, Q - 1]] = np.nan
    return pts, qs


def _check_nan_and_inf(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))


@pytest.mark.parametrize("n", [8192, 6000])
def test_subchunk_minima_matches_jax(n):
    """Same padded arrays (the JAX pad to 2048 rows, so 6000 real rows end
    in +inf-norm padding); two of the 32 queries are NaN."""
    pts, qs = _inputs(n, n)
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    want = np.asarray(jax_subchunk_minima(pp, jnp.asarray(qs), pn, tq=Q,
                                          tn=2048, precision="highest",
                                          interpret=True))
    got = mk.subchunk_minima(torch.from_numpy(np.array(pp)),
                             torch.from_numpy(qs),
                             torch.from_numpy(np.array(pn))).numpy()
    _check_nan_and_inf(got, want)
    assert np.isnan(got[[0, Q - 1]]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [8192, 6000])
def test_bcap_minima_matches_jax(n):
    """The JAX kernel streams block-interleaved planes; a 2048-row granule
    gives its columns the port's 16 contiguous rows."""
    pts, qs = _inputs(n + 1, n)
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    planes, xn_perm = prepare_bcap_planes(pp, pn, tn=2048,
                                          precision="highest")
    want = np.asarray(jax_bcap_minima(planes, jnp.asarray(qs), xn_perm, tq=Q,
                                      tn=2048, granule=2048,
                                      precision="highest", interpret=True))
    got = mk.bcap_minima(torch.from_numpy(np.array(pp)),
                         torch.from_numpy(qs),
                         torch.from_numpy(np.array(pn))).numpy()
    _check_nan_and_inf(got, want)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fn,rows", [(mk.subchunk_minima, mk.SUBCHUNK),
                                     (mk.bcap_minima, mk.BCAP_BLOCK)])
@pytest.mark.parametrize("n,d", [(1000, 17), (4099, 48), (77, 130)])
def test_minima_of_ragged_rows_match_f64(fn, rows, n, d):
    """Row counts that are no multiple of 16 or 128 (the port's own pad to
    64 rows, or none): each column is the minimum over its real rows, NaN
    rows excluded, against an f64 reduction within the f32 product's
    accumulation bound."""
    pts, qs = _inputs(n + d, n, d)
    for pp, pn in (pad_for_pallas(torch.from_numpy(pts)),
                   pad_for_pallas(torch.from_numpy(pts), tn=1)):
        got = fn(pp, torch.from_numpy(qs), pn).numpy()
        n_rows = pp.shape[0]
        assert got.shape == (Q, -(-n_rows // rows))
        p64 = pp.numpy().astype(np.float64)
        q64 = qs.astype(np.float64)
        u = (np.where(np.isfinite(pn.numpy()), (p64 * p64).sum(1), np.inf)
             [None, :] - 2.0 * q64 @ p64.T)
        short = got.shape[1] * rows - n_rows
        u = np.pad(u, ((0, 0), (0, short)), constant_values=np.inf)
        want = u.reshape(Q, -1, rows).min(2)
        _check_nan_and_inf(got, want)
        qn = (q64 * q64).sum(1)
        xn_max = np.nanmax(np.where(np.isfinite(pn.numpy()), pn.numpy(), 0))
        band = d * 2.0 ** -23 * (qn + xn_max)
        fin = np.isfinite(want)
        assert (np.abs(got[fin] - want[fin])
                <= np.broadcast_to(band[:, None], want.shape)[fin]).all()


@pytest.mark.parametrize("n,d", [(1000, 17), (4099, 48), (6000, 130),
                                 (77, 960)])
def test_subchunk_minima_are_min_of_block_minima(n, d):
    """``subchunk_minima_reference`` equals the minimum over each 8 columns
    of ``bcap_minima_reference`` bit for bit, the last subchunk's missing
    blocks as +inf: ragged row counts (no pad, and the port's 64-row pad),
    NaN rows and queries (NaN columns in both)."""
    pts, qs = _inputs(n + 2 * d, n, d)
    q = torch.from_numpy(qs)
    for pp, pn in (pad_for_pallas(torch.from_numpy(pts)),
                   pad_for_pallas(torch.from_numpy(pts), tn=1)):
        sub = mk.subchunk_minima_reference(pp, q, pn)
        blk = mk.bcap_minima_reference(pp, q, pn)
        short = sub.shape[1] * 8 - blk.shape[1]
        blk = torch.nn.functional.pad(blk, (0, short), value=float("inf"))
        want = blk.reshape(Q, -1, 8).amin(2)
        assert sub.shape == want.shape
        assert torch.isnan(sub[[0, Q - 1]]).all()
        assert torch.equal(sub.view(torch.int32), want.view(torch.int32))


def test_cpu_runs_plain_version_and_counts_no_launch():
    pts, qs = _inputs(5, 1024)
    pp, pn = pad_for_pallas(torch.from_numpy(pts))
    before = (mk.subchunk_minima.launches, mk.bcap_minima.launches)
    a = mk.subchunk_minima(pp, torch.from_numpy(qs), pn)
    b = mk.bcap_minima(pp, torch.from_numpy(qs), pn)
    assert (mk.subchunk_minima.launches, mk.bcap_minima.launches) == before
    assert torch.allclose(a, mk.subchunk_minima_reference(
        pp, torch.from_numpy(qs), pn), rtol=0, atol=0, equal_nan=True)
    assert torch.allclose(b, mk.bcap_minima_reference(
        pp, torch.from_numpy(qs), pn), rtol=0, atol=0, equal_nan=True)
    # the block minima of a subchunk's 8 blocks are its minimum: both are
    # the tensor-core tier's
    fin = torch.isfinite(a)
    assert torch.equal(a[fin], b.reshape(Q, -1, 8).amin(2)[fin])


@pytest.mark.parametrize("fn", [mk.subchunk_minima, mk.bcap_minima])
def test_minima_reject_bad_inputs(fn):
    pp, pn = pad_for_pallas(torch.zeros((64, 4)))
    with pytest.raises(TypeError):
        fn(pp.double(), torch.zeros((2, 4), dtype=torch.float64), pn.double())
    with pytest.raises(ValueError):
        fn(pp, torch.zeros((2, 5)), pn)
    with pytest.raises(ValueError):
        fn(pp, torch.zeros((2, 4)), pn[:10])


@pytest.mark.parametrize("d", [48, 128, 960])
def test_bcap_minima_reference_within_tc_bound(d):
    """``bcap_minima`` on the CPU (its plain version, on the tensor-core
    tier's ``_u_tc``) within that tier's bound ``tc_proof_err`` of the f64
    block minima, and against the JAX kernel at "highest" in interpret mode
    within the two tiers' bounds summed (the JAX kernel's own is the FP32
    one, (4·2⁻²³ + d·2⁻²⁴)·(‖q‖² + max ‖x‖²)).  NaN queries NaN, all-padding
    blocks +inf, in both."""
    n = 2048
    pts, qs = _inputs(d + 3, n, d)
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    planes, xn_perm = prepare_bcap_planes(pp, pn, tn=2048,
                                          precision="highest")
    want_jax = np.asarray(jax_bcap_minima(planes, jnp.asarray(qs), xn_perm,
                                          tq=Q, tn=2048, granule=2048,
                                          precision="highest",
                                          interpret=True))
    ppn, pnn = np.array(pp), np.array(pn)
    got = mk.bcap_minima(torch.from_numpy(ppn), torch.from_numpy(qs),
                         torch.from_numpy(pnn)).numpy()
    p64, q64 = ppn.astype(np.float64), qs.astype(np.float64)
    xn64 = np.where(np.isfinite(pnn), (p64 * p64).sum(1), np.inf)
    want = (xn64[None, :] - 2.0 * q64 @ p64.T).reshape(Q, -1, 16).min(2)
    _check_nan_and_inf(got, want)
    _check_nan_and_inf(got, want_jax)
    qn = (qs * qs).sum(1).astype(np.float64)
    xn_max = float(np.where(np.isfinite(pnn), pnn, 0).max())
    tc = kk.tc_proof_err(d, qn, xn_max)[:, None]
    fp32 = ((4 * 2.0 ** -23 + d * 2.0 ** -24) * (qn + xn_max))[:, None]
    fin = np.isfinite(want)
    assert (np.abs(got - want)[fin]
            <= np.broadcast_to(tc, want.shape)[fin]).all()
    assert (np.abs(got - want_jax)[fin]
            <= np.broadcast_to(tc + fp32, want.shape)[fin]).all()

