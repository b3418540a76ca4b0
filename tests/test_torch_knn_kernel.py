"""The port's fold, capped and bcap kernels, as they run on the CPU (their
plain PyTorch versions), against the JAX kernels in interpret mode, on the
same padded arrays from the JAX ``pad_for_pallas`` (as in
tests/test_pallas_kernel.py).

Tolerance: rdist rtol 2e-4 after sorting each row (the two packages sum
the dot product in different orders; the same tolerance as the JAX
kernel's own tests), and the capped/bcap threshold within the same rtol.
Ids are compared as sets wherever the k-th distance is not tied within
that tolerance; the capped and bcap ids on data without near ties must
match exactly as sets."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops.bruteforce import pad_for_pallas as jax_pad
from petal_neighbors_tpu.ops.pallas.knn_kernel import (knn_pallas,
                                                       prepare_bcap_planes)
from petal_neighbors_tpu_torch.ops.bruteforce import PAD_ROWS, pad_for_pallas
from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

TQ, TN, D = 128, 512, 64


def _inputs(seed, n, nan_rows=(), nan_queries=()):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, D)).astype(np.float32) * 100
    qs = rng.random((TQ, D)).astype(np.float32) * 100
    for r in nan_rows:
        pts[r, r % D] = np.nan
    for r in nan_queries:
        qs[r, 3] = np.nan
    return pts, qs


def _both(pts, qs, k, scheme="fold"):
    pp, pn = jax_pad(jnp.asarray(pts), tn=TN)
    # sort_output=False as the serving route calls it (the JAX sort pass
    # repeats an id in +inf slots; the working set itself does not)
    jd, ji = knn_pallas(pp, jnp.asarray(qs), pn, k=k, tq=TQ, tn=TN,
                        interpret=True, sort_output=False, scheme=scheme,
                        precision="highest")
    run = kk.knn_fold_lazy if scheme == "fold_lazy" else kk.knn_fold
    td, ti = run(torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
                 torch.from_numpy(np.array(pn)), k=k)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


def _sorted(rd, ids):
    order = np.argsort(rd, axis=1, kind="stable")
    return (np.take_along_axis(rd, order, 1),
            np.take_along_axis(ids, order, 1))


def _boundary_tied(pts, q, k):
    """The k-th and (k+1)-th exact distances of a query lie within the
    comparison tolerance of each other."""
    ok = ~np.isnan(pts).any(axis=1)
    d = np.sort(((pts[ok].astype(np.float64) - q) ** 2).sum(1))
    return k < len(d) and d[k] - d[k - 1] <= 2e-4 * d[k]


def _check(pts, qs, k, scheme="fold"):
    (jd, ji), (td, ti) = _both(pts, qs, k, scheme)
    assert td.shape == (TQ, k) and ti.dtype == np.int32
    n = pts.shape[0]
    bad = np.isnan(pts).any(axis=1)
    nanq = np.isnan(qs).any(axis=1)
    # NaN query rows: (+inf, -1) in the port; the JAX kernel leaves NaN
    # rdist beside its -1 ids
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    assert (ji[nanq] == -1).all()
    # NaN point rows and padding rows never appear
    sel = ti[ti >= 0]
    assert (sel < n).all() and not bad[sel].any()
    jd, ji = _sorted(jd[~nanq], ji[~nanq])
    td, ti = _sorted(td[~nanq], ti[~nanq])
    np.testing.assert_allclose(td, jd, rtol=2e-4)
    for r, q in enumerate(qs[~nanq]):
        if not _boundary_tied(pts, q.astype(np.float64), k):
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("k", [4, 10, 100])
def test_fold_matches_jax(n, k):
    pts, qs = _inputs(n + k, n)
    _check(pts, qs, k)


@pytest.mark.parametrize("k", [10, 100])
def test_fold_nan_rows_and_queries(k):
    pts, qs = _inputs(k, 1024, nan_rows=(0, 7, 300, 1023),
                      nan_queries=(0, 5, 127))
    _check(pts, qs, k)


@pytest.mark.parametrize("k", [1, 18, 100])
def test_fold_lazy_matches_jax(k):
    """The lazy fold (its plain version on the CPU) against the JAX lazy
    kernel, _knn_kernel_lazy, in interpret mode, NaN rows and queries
    included: the same rdist and, off boundary ties, the same id sets."""
    pts, qs = _inputs(k + 1, 1024, nan_rows=(0, 9, 511, 1023),
                      nan_queries=(1, 64))
    _check(pts, qs, k, "fold_lazy")


def test_fold_lazy_is_fold():
    """fold_lazy's results are fold's bit for bit, ragged tail and k above
    the finite rows included; its plain version counts no launch."""
    pts, qs = _inputs(2, 700, nan_rows=(3, 699), nan_queries=(7,))
    pp, pn = pad_for_pallas(torch.from_numpy(pts))
    before = (kk.knn_fold_lazy.launches, kk.knn_fold.launches)
    for k in (1, 18, 1024):
        lazy = kk.knn_fold_lazy(pp, torch.from_numpy(qs), pn, k=k)
        fold = kk.knn_fold(pp, torch.from_numpy(qs), pn, k=k)
        plain = kk.knn_fold_lazy_reference(pp, torch.from_numpy(qs), pn, k=k)
        for x, y, z in zip(lazy, fold, plain):
            assert torch.equal(x, y) and torch.equal(x, z)
    assert (kk.knn_fold_lazy.launches, kk.knn_fold.launches) == before
    for k in (0, 1025):
        with pytest.raises(ValueError):
            kk.knn_fold_lazy(pp, torch.from_numpy(qs), pn, k=k)


def test_fold_ragged_tail():
    """n not a tile multiple: the JAX pad adds +inf-norm zero rows."""
    pts, qs = _inputs(3, 700, nan_rows=(699,))
    _check(pts, qs, 10)


@pytest.mark.parametrize("k", [500, 512])
def test_fold_k_close_to_n(k):
    """k near n with NaN rows: more slots than finite rows, so the tail
    of every row is (+inf, -1) in both kernels."""
    pts, qs = _inputs(k, 512, nan_rows=(1, 2, 3, 4, 5, 6, 7, 8))
    _check(pts, qs, k)


def test_fold_k_above_n():
    """Fewer rows than slots: the real rows, then (+inf, -1)."""
    pts, qs = _inputs(11, 3)
    _check(pts, qs, 4)


def test_port_pad_matches_jax_pad():
    pts, _ = _inputs(9, 700, nan_rows=(3, 650))
    jp, jn = jax_pad(jnp.asarray(pts), tn=TN)
    tp, tn_ = pad_for_pallas(torch.from_numpy(pts), tn=TN)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tn_.numpy(), np.asarray(jn), rtol=1e-6)
    # the port's own granule: whole bcap blocks
    tp2, tn2 = pad_for_pallas(torch.from_numpy(pts))
    assert tp2.shape[0] % PAD_ROWS == 0 and tp2.shape[0] >= 700
    assert PAD_ROWS % kk.BCAP_BLOCK == 0
    assert np.isposinf(tn2[700:].numpy()).all()


def test_cpu_runs_plain_version_and_counts_no_launch():
    pts, qs = _inputs(4, 256)
    pp, pn = pad_for_pallas(torch.from_numpy(pts))
    before = kk.knn_fold.launches
    a = kk.knn_fold(pp, torch.from_numpy(qs), pn, k=5)
    b = kk.knn_fold_reference(pp, torch.from_numpy(qs), pn, k=5)
    assert kk.knn_fold.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k", [0, 1025])
def test_fold_rejects_k_out_of_range(k):
    pp, pn = pad_for_pallas(torch.zeros((64, 4)))
    with pytest.raises(ValueError):
        kk.knn_fold(pp, torch.zeros((2, 4)), pn, k=k)


def test_fold_rejects_f64():
    pp, pn = pad_for_pallas(torch.zeros((64, 4), dtype=torch.float64))
    with pytest.raises(TypeError):
        kk.knn_fold(pp, torch.zeros((2, 4), dtype=torch.float64), pn, k=2)


# ---- capped and bcap: the proof-gated schemes -----------------------------

CN, CD, CQ = 8192, 32, 64


def _capped_inputs(seed, nan=True):
    rng = np.random.default_rng(seed)
    pts = (rng.random((CN, CD)) * 10).astype(np.float32)
    qs = (rng.random((CQ, CD)) * 10).astype(np.float32)
    if nan:
        pts[[3, 900, CN - 1]] = np.nan
        qs[[5, CQ - 1]] = np.nan
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    return pts, qs, pp, pn


def _jax_scheme(scheme, pp, pn, qs, k, tile, passes):
    if scheme == "capped":
        return knn_pallas(pp, jnp.asarray(qs), pn, k=k, tq=CQ, tn=tile,
                          interpret=True, precision="highest",
                          scheme="capped", passes=passes)
    # the JAX kernel streams block-interleaved planes; a 2048-row granule
    # gives its blocks the port's 16 contiguous rows
    p_perm, xn_perm = prepare_bcap_planes(pp, pn, tn=2048,
                                          precision="highest")
    return knn_pallas(p_perm, jnp.asarray(qs), xn_perm, k=k, tq=CQ,
                      tn=tile * kk.BCAP_BLOCK, interpret=True,
                      precision="highest", scheme="bcap", passes=passes,
                      granule=2048)


def _port_scheme(scheme, pp, pn, qs, k, tile, passes, splits=None):
    args = (torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
            torch.from_numpy(np.array(pn)))
    if splits is not None:
        ref = (kk.knn_capped_reference if scheme == "capped"
               else kk.knn_bcap_reference)
        return [t.numpy() for t in ref(*args, k=k, tile=tile, passes=passes,
                                       splits=splits)]
    run = kk.knn_capped if scheme == "capped" else kk.knn_bcap
    return [t.numpy() for t in run(*args, k=k, tile=tile, passes=passes)]


@pytest.mark.parametrize("scheme,tile", [("capped", 512), ("capped", 2048),
                                         ("bcap", 128)])
@pytest.mark.parametrize("k,passes", [(10, 1), (18, 2), (40, 4), (108, 0)])
def test_capped_schemes_match_jax(scheme, tile, k, passes):
    """Same working set (as a set), same rdist and the same threshold as
    the JAX kernel at the same tile and passes, NaN rows and queries
    included."""
    _, qs, pp, pn = _capped_inputs(k + passes)
    jd, ji, jt = (np.asarray(a) for a in
                  _jax_scheme(scheme, pp, pn, qs, k, tile, passes))
    td, ti, tt = _port_scheme(scheme, pp, pn, qs, k, tile, passes)
    assert td.shape == ji.shape and ti.dtype == np.int32
    assert tt.shape == (CQ,)
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    assert np.isnan(tt[nanq]).all() and np.isnan(jt[nanq]).all()
    np.testing.assert_allclose(np.sort(td[~nanq], 1), np.sort(jd[~nanq], 1),
                               rtol=2e-4)
    np.testing.assert_allclose(tt[~nanq], jt[~nanq], rtol=2e-4)
    for r in np.flatnonzero(~nanq):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r


@pytest.mark.parametrize("scheme,tile", [("capped", 512), ("bcap", 32)])
@pytest.mark.parametrize("splits", [1, 3])
def test_capped_threshold_is_sound(scheme, tile, splits):
    """Every row outside the working set (every block, for bcap) scores at
    least thr, however few the passes and however the rows split into
    ranges (the kernel's launch plan)."""
    pts, qs, pp, pn = _capped_inputs(7 + splits, nan=False)
    k, passes = 12, 1
    td, ti, tt = _port_scheme(scheme, pp, pn, qs, k, tile, passes,
                              splits=splits)
    d2 = ((qs[:, None].astype(np.float64)
           - pts[None].astype(np.float64)) ** 2).sum(-1)
    b = kk.BCAP_BLOCK if scheme == "bcap" else 1
    for r in range(CQ):
        inside = np.zeros(CN, bool)
        for x in ti[r][ti[r] >= 0]:
            inside[x * b:(x + 1) * b] = True
        assert d2[r][~inside].min() >= tt[r] - 1e-3 * tt[r], r
        # the set holds k distinct candidates
        assert len(set(ti[r].tolist())) == k


@pytest.mark.parametrize("scheme,tile", [("capped", 2048), ("bcap", 128)])
def test_capped_splits_merge_ranges(scheme, tile):
    """A plan that splits the rows into ranges runs each range as its own
    index (its own seed) and keeps the k smallest of their sets: the JAX
    kernel on each range, merged, gives the same rdist and threshold."""
    _, qs, pp, pn = _capped_inputs(21)
    k, passes = 10, 2
    td, ti, tt = _port_scheme(scheme, pp, pn, qs, k, tile, passes, splits=2)
    half = CN // 2
    parts = [[np.asarray(a) for a in _jax_scheme(
        scheme, pp[s:s + half], pn[s:s + half], qs, k, tile, passes)]
        for s in (0, half)]
    nanq = np.isnan(qs).any(axis=1)
    jd = np.sort(np.concatenate([p[0] for p in parts], 1), 1)[:, :k]
    jt = np.minimum(np.minimum(parts[0][2], parts[1][2]), jd[:, -1])
    np.testing.assert_allclose(np.sort(td[~nanq], 1), jd[~nanq], rtol=2e-4)
    np.testing.assert_allclose(tt[~nanq], jt[~nanq], rtol=2e-4)


def test_capped_ragged_rows():
    """Rows past n are not seeded and never appear; a first tile shorter
    than k seeds every row and leaves (+inf, -1) slots, and with nothing
    left outside the set the threshold is +inf."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy((rng.random((70, 8)) * 10).astype(np.float32))
    qs = torch.from_numpy((rng.random((9, 8)) * 10).astype(np.float32))
    pn = torch.sum(pts * pts, 1)
    for run, tile in ((kk.knn_capped, 128), (kk.knn_bcap, 8)):
        rd, ids, thr = run(pts, qs, pn, k=8 if run is kk.knn_bcap else 100,
                           tile=tile, passes=2)
        limit = 70 if run is kk.knn_capped else -(-70 // kk.BCAP_BLOCK)
        for row in ids.tolist():
            assert sorted(x for x in row if x >= 0) == list(range(limit))
        assert ((ids == -1) == np.isposinf(rd.numpy())).all()
        assert np.isposinf(thr.numpy()).all()


def test_capped_cpu_runs_plain_version_and_counts_no_launch():
    _, qs, pp, pn = _capped_inputs(3)
    args = (torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
            torch.from_numpy(np.array(pn)))
    before = (kk.knn_capped.launches, kk.knn_bcap.launches)
    a = kk.knn_capped(*args, k=10, tile=512, passes=2)
    b = kk.knn_capped_reference(*args, k=10, tile=512, passes=2)
    c = kk.knn_bcap(*args, k=10, tile=32, passes=2)
    d = kk.knn_bcap_reference(*args, k=10, tile=32, passes=2)
    assert (kk.knn_capped.launches, kk.knn_bcap.launches) == before
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y) or torch.allclose(x, y, equal_nan=True,
                                                   rtol=0, atol=0)


@pytest.mark.parametrize("run", [kk.knn_capped, kk.knn_bcap])
@pytest.mark.parametrize("kw", [dict(k=65, tile=64, passes=2),
                                dict(k=8, tile=64, passes=16),
                                dict(k=8, tile=64, passes=-1),
                                dict(k=1025, tile=2048, passes=2)])
def test_capped_rejects_bad_arguments(run, kw):
    pp, pn = pad_for_pallas(torch.zeros((2048, 4)))
    with pytest.raises(ValueError):
        run(pp, torch.zeros((2, 4)), pn, **kw)


# ---- bcap on the tensor-core tier -----------------------------------------

def _tc_inputs(seed, n, d, q, nan=True):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    if nan:
        pts[[7, n // 2]] = np.nan
        qs[[3, q - 1]] = np.nan
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    return pts, qs, np.array(pp), np.array(pn)


def _tier_bounds(d, qs, pn):
    """Per query: the tensor-core tier's bound and the FP32 one (the JAX
    kernels' own tier on the CPU), each times ‖q‖² + max ‖x‖²."""
    qn = (qs.astype(np.float64) ** 2).sum(1)
    xn_max = float(np.where(np.isfinite(pn), pn, 0).max())
    return (kk.tc_proof_err(d, qn, xn_max),
            (4 * 2.0 ** -23 + d * 2.0 ** -24) * (qn + xn_max))


def _block_minima_f64(pp, pn, qs):
    p64, q64 = pp.astype(np.float64), qs.astype(np.float64)
    xn = np.where(np.isfinite(pn), (p64 * p64).sum(1), np.inf)
    u = xn[None, :] - 2.0 * q64 @ p64.T
    return u.reshape(len(qs), -1, kk.BCAP_BLOCK).min(2)


@pytest.mark.parametrize("d", [128, 960])
def test_bcap_reference_matches_jax_highest(d):
    """``knn_bcap_reference`` (on ``_u_tc``) against ``knn_pallas(scheme=
    "bcap", precision="highest", interpret=True)`` on the same padded
    arrays, NaN rows and queries included: rdist and thr within the two
    tiers' bounds summed (each side within its own of the exact value: the
    tensor-core one here, the FP32 one for the JAX kernel on the CPU), and
    the same block ids as sets but where a block left out by one side and
    one kept by it have f64 block minima within twice that band (a near
    tie), on most queries none."""
    k, tile, passes, nq = 18, 128, 2, 16
    pts, qs, pp, pn = _tc_inputs(d, 4096, d, nq)
    p_perm, xn_perm = prepare_bcap_planes(jnp.asarray(pp), jnp.asarray(pn),
                                          tn=2048, precision="highest")
    jd, ji, jt = (np.asarray(a) for a in knn_pallas(
        p_perm, jnp.asarray(qs), xn_perm, k=k, tq=8,
        tn=tile * kk.BCAP_BLOCK, interpret=True, precision="highest",
        scheme="bcap", passes=passes, granule=2048))
    td, ti, tt = (t.numpy() for t in kk.knn_bcap_reference(
        torch.from_numpy(pp), torch.from_numpy(qs), torch.from_numpy(pn),
        k=k, tile=tile, passes=passes))
    tc, fp32 = _tier_bounds(d, qs, pn)
    band = tc + fp32
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isnan(tt[nanq]).all()
    assert np.isnan(jt[nanq]).all()
    ok = ~nanq
    assert (np.abs(np.sort(td[ok], 1) - np.sort(jd[ok], 1))
            <= band[ok, None]).all()
    assert (np.abs(tt[ok] - jt[ok]) <= band[ok]).all()
    bm = _block_minima_f64(pp, pn, qs)
    same = 0
    for r in np.flatnonzero(ok):
        a_only = sorted(bm[r][list(set(ti[r].tolist()) - set(ji[r].tolist()))])
        b_only = sorted(bm[r][list(set(ji[r].tolist()) - set(ti[r].tolist()))])
        assert len(a_only) == len(b_only), r
        assert all(abs(x - y) <= 2 * band[r]
                   for x, y in zip(a_only, b_only)), r
        same += not a_only
    assert same >= ok.sum() // 2


@pytest.mark.parametrize("d", [128, 960])
@pytest.mark.parametrize("splits", [1, 3])
def test_bcap_threshold_is_sound_on_the_tc_bound(d, splits):
    """Every block outside bcap's working set scores at least thr −
    ``tc_proof_err`` in the exact (f64) squared distance, however
    few the passes and however the rows split into ranges: the route's
    proof for bcap and bcap2 holds on the tensor-core tier."""
    k, tile, passes, nq, n = 12, 32, 1, 16, 4096
    pts, qs, pp, pn = _tc_inputs(d + splits, n, d, nq, nan=False)
    td, ti, tt = kk.knn_bcap_reference(
        torch.from_numpy(pp), torch.from_numpy(qs), torch.from_numpy(pn),
        k=k, tile=tile, passes=passes, splits=splits)
    qt = torch.from_numpy(qs)
    xn = torch.from_numpy(pn)
    err = kk.tc_proof_err(d, torch.sum(qt * qt, 1),
                          torch.max(torch.where(torch.isfinite(xn), xn,
                                                0.0))).numpy()
    d2 = ((qs[:, None].astype(np.float64)
           - pts[None].astype(np.float64)) ** 2).sum(-1)
    b = kk.BCAP_BLOCK
    ti, tt = ti.numpy(), tt.numpy()
    for r in range(nq):
        inside = np.zeros(n, bool)
        for x in ti[r][ti[r] >= 0]:
            inside[x * b:(x + 1) * b] = True
        assert d2[r][~inside].min() >= tt[r] - err[r], r
        assert len(set(ti[r].tolist())) == k


def test_bcap_tile_rule():
    """On the card a bcap tile is a whole number of 64-row tiles of
    selection (4 blocks), and a capped tile of 64 rows; the tensor-core
    product's 128-row tiles serve a 64-row half where a range ends in
    one.  Anything else raises ValueError before a launch."""
    assert kk.TILE_ROWS == 64
    assert kk._tile_tiles("bcap", 128) == 32
    assert kk._tile_tiles("bcap", 4) == 1
    assert kk._tile_tiles("bcap", 12) == 3
    assert kk._tile_tiles("capped", 4096) == 64
    for scheme, tile in (("bcap", 2), ("bcap", 6), ("bcap", 130),
                         ("capped", 100)):
        with pytest.raises(ValueError, match="multiple"):
            kk._tile_tiles(scheme, tile)

@pytest.mark.parametrize("k", [1, 18, 1024])
@pytest.mark.parametrize("nq", [1, 127, 129, 300])
def test_scratch_shapes_of_the_lazy_block(k, nq):
    """fold_lazy's launch scratch on its 128-query block (the card's
    ``_block_queries("fold_lazy")``): one arrival counter per started block
    of 128 queries at ragged q, the working sets in global memory only
    where they are not in shared memory or the rows split into ranges, and
    no miss (fold_lazy keeps no threshold); capped keeps a miss a range."""
    tq = 128
    blocks = -(-nq // tq)
    for splits, ws_smem in ((1, True), (1, False), (8, True), (8, False)):
        part, miss, count = kk._scratch_shapes("fold_lazy", nq, k, splits,
                                              ws_smem, tq)
        assert count == (blocks,)
        assert part == ((splits, nq, k) if splits > 1 or not ws_smem
                        else (0,))
        assert miss == (0,)
        _, cmiss, _ = kk._scratch_shapes("capped", nq, k, splits, ws_smem,
                                        tq)
        assert cmiss == ((splits, nq) if splits > 1 else (0,))


# ---- merge: the exact top-k for k up to 4096 ------------------------------

@pytest.mark.parametrize("k", [1500, 37])
def test_merge_matches_jax(k):
    """The port's merge (its plain version on the CPU) against the JAX
    merge kernel in interpret mode, NaN point and query rows included, in
    the style of tests/test_pallas_kernel.py's merge tests: rdist rtol
    2e-4 after sorting, ids as sets except at boundary ties, the port's
    rows ascending."""
    rng = np.random.default_rng(k)
    n, d, q = 8192, 32, 16
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    pts[[7, 4000]] = np.nan
    qs[[3, 11]] = np.nan
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    jd, ji = (np.asarray(a) for a in knn_pallas(
        pp, jnp.asarray(qs), pn, k=k, tq=8, tn=2048, interpret=True,
        scheme="merge", sort_output=False))
    td, ti = (t.numpy() for t in kk.knn_merge(
        torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
        torch.from_numpy(np.array(pn)), k=k))
    assert td.shape == (q, k) and ti.dtype == np.int32
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    assert (ji[nanq] == -1).all()
    sel = ti[ti >= 0]
    assert (sel < n).all() and not np.isnan(pts[sel]).any()
    assert (np.diff(td[~nanq], axis=1) >= 0).all()
    np.testing.assert_allclose(td[~nanq], np.sort(jd[~nanq], 1), rtol=2e-4)
    for r in np.flatnonzero(~nanq):
        if not _boundary_tied(pts, qs[r].astype(np.float64), k):
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r


def test_merge_k_above_n_and_limits():
    """Fewer finite rows than k: the real rows ascending, then (+inf, -1);
    its first 1000 columns are merge's own at k=1000 bit for bit, and
    fold's (the FP32 tier) within rtol 2e-4 with the same ids but at
    boundary ties; k outside 1..4096 raises; the CPU counts no launch."""
    pts, qs = _inputs(12, 300, nan_rows=(5,))
    pp, pn = pad_for_pallas(torch.from_numpy(pts))
    before = kk.knn_merge.launches
    rd, ids = kk.knn_merge(pp, torch.from_numpy(qs), pn, k=4096)
    assert kk.knn_merge.launches == before
    m_rd, m_ids = kk.knn_merge(pp, torch.from_numpy(qs), pn, k=1000)
    assert torch.equal(rd[:, :1000], m_rd)
    assert torch.equal(ids[:, :1000], m_ids)
    fold_rd, fold_ids = kk.knn_fold(pp, torch.from_numpy(qs), pn, k=1000)
    fin = torch.isfinite(fold_rd)
    assert torch.equal(fin, torch.isfinite(m_rd))
    np.testing.assert_allclose(m_rd[fin].numpy(), fold_rd[fin].numpy(),
                               rtol=2e-4)
    for r in range(qs.shape[0]):
        if not _boundary_tied(pts, qs[r].astype(np.float64), 1000):
            assert (set(m_ids[r].tolist())
                    == set(fold_ids[r].tolist())), r
    assert (ids[:, :299] >= 0).all() and (ids[:, 299:] == -1).all()
    assert torch.isinf(rd[:, 299:]).all()
    for k in (0, 4097):
        with pytest.raises(ValueError):
            kk.knn_merge(pp, torch.from_numpy(qs), pn, k=k)


# ---- merge's edge rows against a stable sort ------------------------------

def _stable_topk(points, queries, norms, k):
    """The k smallest (u, id) of the tier's u by one stable sort of each
    whole row (ties in id order); +inf and NaN u never count."""
    u = kk._u_tc(points, queries, norms, 0, points.shape[0])
    u = torch.where(torch.isnan(u), torch.inf, u)
    su, pos = torch.sort(u, dim=1, stable=True)
    su, pos = su[:, :k], pos[:, :k].to(torch.int32)
    if su.shape[1] < k:
        fill = k - su.shape[1]
        su = torch.nn.functional.pad(su, (0, fill), value=float("inf"))
        pos = torch.nn.functional.pad(pos, (0, fill), value=-1)
    ids = torch.where(torch.isinf(su), -1, pos)
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    return torch.where(ids < 0, torch.inf, torch.clamp_min(su + qn, 0.0)), ids


def _edge(kind):
    rng = np.random.default_rng(5)
    if kind == "all equal":
        pts = np.repeat(rng.random((1, 32), dtype=np.float32), 5000, 0)
        return pts, rng.random((6, 32), dtype=np.float32), 4096
    if kind == "duplicates":
        base = rng.integers(0, 16, (40, 32)).astype(np.float32)
        return (base[rng.integers(0, 40, 6000)],
                rng.integers(0, 16, (6, 32)).astype(np.float32), 3000)
    if kind == "+inf tail":
        pts = rng.random((5000, 32), dtype=np.float32)
        pts[rng.random(5000) < 0.4] = np.nan
        return pts, rng.random((6, 32), dtype=np.float32), 4096
    pts = rng.random((900, 32), dtype=np.float32)
    return pts, rng.random((6, 32), dtype=np.float32), 1024


@pytest.mark.parametrize("kind", ["all equal", "duplicates", "+inf tail",
                                  "k above n"])
def test_merge_edge_rows_match_stable_sort(kind):
    """Merge at k up to 4096 on its edge rows equals one stable sort of the
    whole row bit for bit: all keys equal gives ids 0..k-1, duplicates tie
    in id order, NaN rows and rows past the finite ones give (+inf, -1)."""
    pts, qs, k = _edge(kind)
    pp, pn = pad_for_pallas(torch.from_numpy(pts))
    q = torch.from_numpy(qs)
    rd, ids = kk.knn_merge(pp, q, pn, k=k)
    want_rd, want_ids = _stable_topk(pp, q, pn, k)
    assert torch.equal(ids, want_ids)
    assert torch.equal(rd, want_rd)
    if kind == "all equal":
        assert torch.equal(ids, torch.arange(k, dtype=torch.int32)
                           .expand_as(ids))
    n_fin = int(torch.isfinite(pn).sum())
    if n_fin < k:
        assert (ids[:, n_fin:] == -1).all() and (ids[:, :n_fin] >= 0).all()
