"""fold for the shapes the route runs it at: the choice between its
paths on the card (``fold_path``), the select path's layout, and
``knn_fold`` (its plain version on the CPU) against the JAX fold kernel in
interpret mode at the route's repair shapes; then the route's repair
(``_prove_repair``) end to end against the JAX route.

Tolerance: rdist rtol 2e-4 after sorting each row (the two packages sum
the dot product in different orders; as tests/test_torch_knn_kernel.py),
ids as sets off boundary ties.  On integer data every product is exact,
so there the ids must be the (u, id)-order answer exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops import bruteforce as jbf
from petal_neighbors_tpu.ops.pallas.knn_kernel import knn_pallas
from petal_neighbors_tpu_torch.ops import bruteforce as tbf
from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

TQ, TN, D = 8, 512, 64

#: the route's fold repairs at 1M rows (PERF.md §5): (queries, k_scan, d,
#: the path fold_path must take there)
REPAIRS = ((5, 18, 128, "few"), (187, 108, 128, "select"),
           (47, 208, 128, "select"), (56, 1008, 128, "select"),
           (1, 18, 960, "few"), (2, 18, 960, "few"))
N_ROWS = 10 ** 6


def _inputs(seed, n, q, nan_rows=(), nan_queries=()):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, D)).astype(np.float32) * 100
    qs = rng.random((q, D)).astype(np.float32) * 100
    for r in nan_rows:
        pts[r, r % D] = np.nan
    for r in nan_queries:
        qs[r, 3] = np.nan
    return pts, qs


def _both(pts, qs, k):
    """The JAX fold kernel (interpret mode; queries padded with NaN rows to
    its tile) and the port's knn_fold on the same padded arrays."""
    pp, pn = jbf.pad_for_pallas(jnp.asarray(pts), tn=TN)
    q = qs.shape[0]
    qpad = np.full((-(-q // TQ) * TQ, qs.shape[1]), np.nan, np.float32)
    qpad[:q] = qs
    jd, ji = knn_pallas(pp, jnp.asarray(qpad), pn, k=k, tq=TQ, tn=TN,
                        interpret=True, sort_output=False, scheme="fold",
                        precision="highest")
    td, ti = kk.knn_fold(torch.from_numpy(np.array(pp)),
                         torch.from_numpy(qs),
                         torch.from_numpy(np.array(pn)), k=k)
    return (np.asarray(jd)[:q], np.asarray(ji)[:q]), (td.numpy(), ti.numpy())


def _sorted(rd, ids):
    order = np.argsort(rd, axis=1, kind="stable")
    return (np.take_along_axis(rd, order, 1),
            np.take_along_axis(ids, order, 1))


def _boundary_tied(pts, q, k):
    ok = ~np.isnan(pts).any(axis=1)
    d = np.sort(((pts[ok].astype(np.float64) - q) ** 2).sum(1))
    return k < len(d) and d[k] - d[k - 1] <= 2e-4 * d[k]


# ---- the cutover and the layout --------------------------------------------

@pytest.mark.parametrize("q,k,d,path", REPAIRS)
def test_repairs_take_the_faster_path(q, k, d, path):
    """Every repair shape of the route takes the path chip_smoke.py's
    timing on the card (phases fold_paths and few_query) found fastest
    there: the few-query kernel at k_scan 18 with a few queries (SIFT's 5,
    GIST's one and two), the select above FEW_K_MAX or the rule's
    counts."""
    assert kk.fold_path(q, k, d, N_ROWS) == path


@pytest.mark.parametrize("k", [18, 108, 208])
def test_full_batches_at_small_k_stay_on_the_streaming_kernel(k):
    """10,240 queries at k_scan 18, 108 and 208 take the streaming kernel
    (two product passes cost more than fold's one there); at k_scan 1008
    the select is faster even there."""
    assert kk.fold_path(10240, k, 128, N_ROWS) == "stream"
    assert kk.fold_path(10240, 1008, 128, N_ROWS) == "select"


@pytest.mark.parametrize("tier", sorted(kk.FOLD_SELECT_Q))
def test_fold_path_follows_its_table(tier):
    """The rule is FOLD_SELECT_Q read as documented: a width takes the
    narrowest tier at or above it (the widest past them all), a k the row
    of the largest k_scan at or below it (the first below them all), and
    a row selects for fewest <= Q <= most; wherever ``few_path`` takes
    the shape, the few-query kernel runs first."""
    def path(q, k, d):
        got = kk.fold_path(q, k, d, N_ROWS)
        if kk.few_path(q, d, k, N_ROWS):
            assert got == "few"
            return table(q, k, d)
        return got

    def table(q, k, d):
        _, fewest, most = max((r for r in kk.FOLD_SELECT_Q[tier]
                               if r[0] <= k),
                              default=kk.FOLD_SELECT_Q[tier][0])
        return "select" if fewest <= q and (most is None or q <= most) \
            else "stream"

    rows = kk.FOLD_SELECT_Q[tier]
    assert [r[0] for r in rows] == sorted(r[0] for r in rows)
    assert rows[0][0] <= 18 and rows[-1][0] <= kk.FOLD_K_MAX
    narrower = [t for t in kk.FOLD_SELECT_Q if t < tier]
    widths = [tier, max(narrower, default=0) + 1]
    if tier == max(kk.FOLD_SELECT_Q):
        widths.append(4 * tier)
    for i, (k0, fewest, most) in enumerate(rows):
        k_next = rows[i + 1][0] if i + 1 < len(rows) else kk.FOLD_K_MAX + 1
        ks = {k0, k_next - 1} | ({1} if i == 0 else set())
        for d in widths:
            for k in ks:
                if fewest > 1:
                    assert path(fewest - 1, k, d) == "stream"
                if most is None:
                    assert path(10 ** 6, k, d) == "select"
                    continue
                if fewest <= most:
                    assert path(fewest, k, d) == "select"
                    assert path(most, k, d) == "select"
                assert path(most + 1, k, d) == "stream"


@pytest.mark.parametrize("k", [0, kk.FOLD_K_MAX + 1])
def test_fold_path_rejects_k_out_of_range(k):
    with pytest.raises(ValueError):
        kk.fold_path(5, k, 128, N_ROWS)


@pytest.mark.parametrize("n", [1, 700, 70001, 1_000_000])
@pytest.mark.parametrize("k", [1, 18, 108, 208, 1008, 1024])
def test_fp32_select_layout(n, k):
    """The FP32 select's groups stay inside one 64-row tile: the
    tensor-core layout with G capped at 64; lists as wide."""
    glog, width = kk.merge_layout(n, k, "fp32")
    tc_glog, tc_width = kk.merge_layout(n, k)
    assert 4 <= glog <= 6 and glog == min(tc_glog, 6)
    assert width == tc_width == min(8192, k + max(k, 1024))
    assert width >= k + 1024 and width <= 2 * kk.FOLD_K_MAX
    if -(-n // 16) >= 1.5 * k:
        assert -(-n // (1 << glog)) >= 1.5 * k


# ---- knn_fold against the JAX fold kernel at repair shapes ------------------

@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("k", [18, 108, 1008])
def test_fold_matches_jax_at_repair_shapes(q, k):
    """A few queries over the whole (small) index, NaN rows included: the
    same rdist and, off boundary ties, the same ids."""
    n = 3000
    pts, qs = _inputs(q * 1000 + k, n, q, nan_rows=(0, 7, 1500, n - 1))
    (jd, ji), (td, ti) = _both(pts, qs, k)
    assert td.shape == (q, k) and ti.dtype == np.int32
    bad = np.isnan(pts).any(axis=1)
    sel = ti[ti >= 0]
    assert (sel < n).all() and not bad[sel].any()
    jd, ji = _sorted(jd, ji)
    td, ti = _sorted(td, ti)
    np.testing.assert_allclose(td, jd, rtol=2e-4)
    for r in range(q):
        if not _boundary_tied(pts, qs[r].astype(np.float64), k):
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r


def test_fold_nan_query_and_k_above_finite_rows():
    """A NaN query among five keeps (+inf, -1); with k above the finite
    rows the tail is (+inf, -1), as the JAX kernel's ids."""
    n, k = 700, 1008
    pts, qs = _inputs(3, n, 5, nan_rows=(1, 2, 699), nan_queries=(2,))
    (jd, ji), (td, ti) = _both(pts, qs, k)
    assert (ti[2] == -1).all() and np.isposinf(td[2]).all()
    assert (ji[2] == -1).all()
    fin = n - 3
    for r in (0, 1, 3, 4):
        assert (ti[r] >= 0).sum() == fin == (ji[r] >= 0).sum()
        assert set(ti[r][ti[r] >= 0].tolist()) == set(
            ji[r][ji[r] >= 0].tolist())
    td_s, _ = _sorted(td[[0, 1, 3, 4]], ti[[0, 1, 3, 4]])
    jd_s, _ = _sorted(jd[[0, 1, 3, 4]], ji[[0, 1, 3, 4]])
    np.testing.assert_allclose(td_s[:, :fin], jd_s[:, :fin], rtol=2e-4)
    assert np.isposinf(td_s[:, fin:]).all()


@pytest.mark.parametrize("k", [18, 108])
def test_fold_duplicate_ties_at_the_kth_value(k):
    """Points drawn from 20 distinct integer rows: every u is exact and
    each value is shared by about 100 rows, so the k-th value is tied.
    knn_fold keeps the (u, id)-order answer exactly (ties to the smaller
    id, as the select path on the card does), and the JAX kernel the same
    rdist."""
    rng = np.random.default_rng(k)
    base = rng.integers(0, 16, (20, D)).astype(np.float32)
    pts = base[rng.integers(0, 20, 2048)]
    qs = rng.integers(0, 16, (5, D)).astype(np.float32)
    (jd, ji), (td, ti) = _both(pts, qs, k)
    d2 = ((pts[None].astype(np.int64) - qs[:, None].astype(np.int64)) ** 2
          ).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(len(pts)), d2.shape), d2),
                      axis=1)[:, :k]
    td_s, ti_s = _sorted(td, ti)
    np.testing.assert_array_equal(ti_s, want)
    np.testing.assert_array_equal(td_s, np.take_along_axis(d2, want, 1))
    np.testing.assert_allclose(_sorted(jd, ji)[0], td_s, rtol=2e-4)


def test_fold_path_argument_on_the_cpu():
    """``path`` forces a path on the card; on the CPU either runs the plain
    version and counts no launch; anything else raises."""
    pts, qs = _inputs(5, 600, 3)
    pp, pn = tbf.pad_for_pallas(torch.from_numpy(pts))
    q = torch.from_numpy(qs)
    before = kk.knn_fold.launches
    want = kk.knn_fold_reference(pp, q, pn, k=9)
    for path in (None, "select", "stream"):
        got = kk.knn_fold(pp, q, pn, k=9, path=path)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert kk.knn_fold.launches == before
    with pytest.raises(ValueError):
        kk.knn_fold(pp, q, pn, k=9, path="merge")


# ---- the route's repair -----------------------------------------------------

@pytest.mark.parametrize("k_eff", [10, 200])
def test_prove_repair_matches_jax_route(k_eff, monkeypatch):
    """``_prove_repair`` on a batch whose proof left four queries
    uncovered (forced): one fold call on exactly those queries, their rows
    replaced by the exact answer (against the JAX route's fold answer on
    the same padded index), the covered rows left as they were."""
    rng = np.random.default_rng(k_eff)
    n, q = 4096, 16
    pts = rng.standard_normal((n, 32)).astype(np.float32)
    qs = rng.standard_normal((q, 32)).astype(np.float32)
    pts[[5, 3000]] = np.nan
    mu = jbf.center_of(jnp.asarray(pts))
    pp, pn = jbf.pad_for_pallas(jnp.asarray(pts) - mu, tn=TN)
    jd, ji = (np.asarray(a) for a in jbf.knn_pallas_prepadded(
        pp, pn, jnp.asarray(qs), k_eff, n, mu, precision="highest",
        interpret=True, scheme="fold", tn=TN))
    unc = np.array([0, 3, 7, 15])
    covered = np.ones(q, bool)
    covered[unc] = False
    best_rd = torch.full((q, k_eff), 123.0)
    best_i = torch.full((q, k_eff), 7, dtype=torch.int32)
    calls = []
    fold = tbf.knn_fold
    monkeypatch.setattr(tbf, "knn_fold", lambda *a, **kw: calls.append(
        (a[1].shape[0], kw["k"])) or fold(*a, **kw))
    k_scan = tbf.scan_width("capped", k_eff, n)
    qc = torch.from_numpy(qs) - torch.from_numpy(np.array(mu))
    rd, ids = tbf._prove_repair(
        torch.from_numpy(covered), best_rd, best_i,
        torch.from_numpy(np.array(pp)), torch.from_numpy(np.array(pn)), qc,
        k_eff, k_scan, n)
    assert calls == [(len(unc), k_scan)]
    assert (rd[covered] == 123.0).all() and (ids[covered] == 7).all()
    rd, ids = rd.numpy()[unc], ids.numpy()[unc]
    np.testing.assert_allclose(np.sqrt(rd), jd[unc], rtol=1e-4, atol=1e-4)
    assert (np.diff(rd, axis=1) >= 0).all()
    for r, qi in enumerate(unc):
        if not _boundary_tied(pts, qs[qi].astype(np.float64), k_eff):
            assert set(ids[r].tolist()) == set(ji[qi].tolist()), qi
