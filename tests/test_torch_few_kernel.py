"""The few-query kernel's plain version and its rule (``knn_few``,
``few_path``; ``csrc/knn_few.cu`` runs on the card only): exact selection
against fold's plain version and a float64 oracle, fold's contract below
k finite rows, and the route's choice of the fold route at the rule's
shapes (``_few_takes_fold``, applied on the CPU by a patch) against the
float64 oracle and against the proof route.

Tolerance: the ids' float64 distances against the oracle's k smallest
within the FP32 tier's bound (the plain version's matmul sums in another
order than the oracle)."""

import numpy as np
import pytest
import torch

from petal_neighbors_tpu_torch.ops import bruteforce as tbf
from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
from petal_neighbors_tpu_torch.utils import profiling


def _index(seed, n, q, d, nan_rows=True, nan_query=True):
    """Centred, padded points (NaN rows zeroed with +inf norms, ragged n
    padded to 64 rows) and queries, a NaN query among them where q > 1."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, d)).astype(np.float32) * 100
    qs = rng.random((q, d)).astype(np.float32) * 100
    if nan_rows and n > 20:
        pts[[2, n - 1]] = np.nan
        pts[7, d // 2] = np.nan
    if nan_query and q > 1:
        qs[q // 2, d - 1] = np.nan
    p = torch.from_numpy(pts)
    mu = tbf.center_of(p)
    pp, pn = tbf.pad_for_pallas(p - mu)
    return pp, pn, torch.from_numpy(qs) - mu


def _rd64(pp, pn, qt):
    """(Q, N) float64 squared distances, +inf on +inf-norm rows."""
    diff = qt.double()[:, None, :] - pp.double()[None, :, :]
    rd = (diff * diff).sum(-1)
    return torch.where(torch.isfinite(pn)[None, :], rd, torch.inf)


def _fp32_err(d, qt, pn):
    """The FP32 SIMT product's pointwise bound on |u − true u|: 4x the f32
    rounding plus the sequential-sum term d·2⁻²⁴, times ‖q‖² + max ‖x‖²."""
    qn = torch.sum(qt.double() ** 2, dim=1)
    xn = torch.where(torch.isfinite(pn), pn, 0).max().double()
    return (4 * 2.0 ** -23 + d * 2.0 ** -24) * (qn + xn)


@pytest.mark.parametrize("k", [1, 10, 18, 100])
@pytest.mark.parametrize("d", [1, 7, 128, 960])
@pytest.mark.parametrize("q", [1, 2, 5, 16])
def test_fold_mode_is_exact(q, d, k):
    """fold mode keeps the exact k smallest FP32 u: fold's plain version's
    rdist and ids, and ids whose float64 distances are the oracle's k
    smallest within the FP32 bound; a NaN query and the slots past the
    finite rows are (+inf, -1)."""
    n = 37 if k == 100 else 437            # k >= n at k = 100
    pp, pn, qt = _index(q * 1000 + d + k, n, q, d)
    rd, ids = kk.knn_few(pp, qt, pn, k=k)
    frd, fids = kk.knn_fold_reference(pp, qt, pn, k=k)
    assert torch.equal(rd, frd) and torch.equal(ids, fids)
    rd64 = _rd64(pp, pn, qt)
    want = torch.sort(rd64, dim=1).values
    want = torch.nn.functional.pad(want, (0, max(0, k - want.shape[1])),
                                   value=float("inf"))[:, :k]
    got = torch.where(ids >= 0,
                      torch.gather(rd64, 1, ids.clamp_min(0).long()),
                      torch.inf)
    got = torch.sort(got, dim=1).values
    nanq = torch.isnan(qt).any(dim=1)
    assert bool((ids[nanq] == -1).all()) and bool(torch.isinf(rd[nanq]).all())
    ok = ~nanq
    fin = torch.isfinite(want[ok])
    assert torch.equal(torch.isfinite(got[ok]), fin)
    gap = (got[ok] - want[ok]).abs().where(fin, 0)
    assert bool((gap <= _fp32_err(d, qt, pn)[ok, None]).all())
    finite_rows = int(torch.isfinite(pn).sum())
    assert int((ids[ok] >= 0).sum(dim=1).min()) == min(k, finite_rows)


def test_threshold_is_inf_below_k_finite_rows():
    """Fewer than k finite rows: fold's contract keeps them all, in the
    first slots of the plain version's ascending rows, and the other slots
    are (+inf, -1); there is no threshold."""
    pp, pn, qt = _index(3, 30, 2, 8, nan_query=False)
    finite = int(torch.isfinite(pn).sum())
    for k in (finite + 1, 40):
        out = kk.knn_few(pp, qt, pn, k=k)
        assert len(out) == 2
        rd, ids = out
        assert torch.equal(ids < 0, torch.isinf(rd))
        assert bool((ids[:, :finite] >= 0).all())
        assert bool((ids[:, finite:] == -1).all())
        kept = torch.sort(ids[:, :finite], dim=1).values
        want = torch.nonzero(torch.isfinite(pn)).flatten().to(torch.int32)
        assert torch.equal(kept, want.expand_as(kept))


def test_few_path_is_a_rule_on_the_shape():
    """few_path is a pure function of (q, d, k, n) read from FEW_RULE: the
    same answer every time; it takes q <= 4 at d = 128 and 960 at k_scan
    18 over 1M rows (the single queries and the few-query repairs); it
    never takes k above FEW_K_MAX, q above the rule's most, or a width past
    its widest tier, so the other kernels keep those shapes; a width
    between two measured ones takes the smaller count of the two."""
    most = max(m for rows in kk.FEW_RULE.values() for _, m in rows)
    widest = max(kk.FEW_RULE)
    for d in (1, 2, 8, 128, 960):
        for q in (1, 2, 3, 4):
            assert kk.few_path(q, d, 18, 10 ** 6)
            assert kk.few_path(q, d, 18, 10 ** 6) == kk.few_path(q, d, 18,
                                                                 10 ** 6)
    for d in (1, 8, 128, 960, widest, widest + 1, 4096):
        for k in (1, 18, 108, kk.FEW_K_MAX, kk.FEW_K_MAX + 1):
            for n in (1, 10 ** 5, 10 ** 6):
                assert not kk.few_path(most + 1, d, k, n)
                assert not kk.few_path(0, d, k, n)
                if k > kk.FEW_K_MAX or d > widest:
                    assert not kk.few_path(1, d, k, n)
    for tier, rows in kk.FEW_RULE.items():
        assert [kk_ for kk_, _ in rows] == sorted(kk_ for kk_, _ in rows)
        for k, m in rows:
            assert kk.few_path(m, tier, k, 10 ** 6)
            assert not kk.few_path(m + 1, tier, k, 10 ** 6)
    # a width between two measured ones takes the smaller count of the two
    widths = sorted(kk.FEW_RULE)
    for lo, hi in zip(widths, widths[1:]):
        if hi - lo < 2:
            continue
        for k in (1, 18, 19, 108, kk.FEW_K_MAX):
            counts = [next((m for kk_, m in kk.FEW_RULE[t] if k <= kk_), 0)
                      for t in (lo, hi)]
            for d in (lo + 1, (lo + hi) // 2, hi - 1):
                if min(counts):
                    assert kk.few_path(min(counts), d, k, 10 ** 6)
                assert not kk.few_path(min(counts) + 1, d, k, 10 ** 6)


def test_paths_and_modes_are_checked_on_the_cpu():
    """``knn_fold`` refuses an unknown path and ``knn_few`` k past the
    kernel's limit before they run; on CPU tensors fold, capped and bcap
    run their plain versions whatever the rule says (capped and bcap at
    every query count, as their tile kernels do on the card), and none
    counts a few-query launch."""
    pp, pn, qt = _index(5, 500, 2, 8)
    with pytest.raises(ValueError, match="path"):
        kk.knn_fold(pp, qt, pn, k=4, path="wide")
    with pytest.raises(ValueError):
        kk.knn_few(pp, qt, pn, k=kk.FEW_K_MAX + 1)
    assert kk.few_path(2, 8, 4, pp.shape[0])
    before = kk.knn_few.launches
    for path in (None, "few", "select", "stream"):
        rd, ids = kk.knn_fold(pp, qt, pn, k=4, path=path)
        frd, fids = kk.knn_fold_reference(pp, qt, pn, k=4)
        assert torch.equal(rd, frd) and torch.equal(ids, fids)
    for run, ref, tile in ((kk.knn_capped, kk.knn_capped_reference, 64),
                           (kk.knn_bcap, kk.knn_bcap_reference, 8)):
        got = run(pp, qt, pn, k=4, tile=tile, passes=2)
        want = ref(pp, qt, pn, k=4, tile=tile, passes=2)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert kk.knn_few.launches == before


def _rule_on_cpu(scheme, queries, k_scan, n_padded):
    """``_few_takes_fold`` with its card test left out: the rule alone."""
    q, d = queries.shape
    return (scheme in ("bcap", "capped") and k_scan <= kk.FOLD_K_MAX
            and kk.fold_path(q, k_scan, d, n_padded) == "few")


def _route_inputs(seed, n, q, d):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.random((n, d)).astype(np.float32) * 50)
    qs = torch.from_numpy(rng.random((q, d)).astype(np.float32) * 50)
    mu, pp, pn, _ = tbf.prepare_euclidean_index(pts)
    return pts, qs, mu, pp, pn


@pytest.mark.parametrize("q", [1, 6, 16])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("scheme", ["bcap", "capped"])
def test_few_shapes_take_the_fold_route(scheme, d, q, monkeypatch):
    """Where ``knn_fold`` would run the few-query kernel, a bcap or capped
    call (forced here, as ``BruteForce`` forces its pick) takes the fold
    route: neither tile kernel is called, ``knn_fold`` runs once at the
    scheme's ``k_scan`` on all the queries, nothing is proved or repaired
    (``route.repaired`` is never counted), and the answers are the float64
    oracle's."""
    n, k = 5000, 10
    pts, qs, mu, pp, pn = _route_inputs(d * 100 + q, n, q, d)
    k_scan = tbf.scan_width(scheme, k, n)
    assert kk.fold_path(q, k_scan, d, pp.shape[0]) == "few"

    def tile_kernel(*a, **kw):
        raise AssertionError("a tile kernel ran at a few-query shape")

    folds = []
    fold = tbf.knn_fold

    def counted_fold(p, qq, xn, *, k):
        folds.append((qq.shape[0], k))
        return fold(p, qq, xn, k=k)

    monkeypatch.setattr(tbf, "_few_takes_fold", _rule_on_cpu)
    monkeypatch.setattr(tbf, "knn_capped", tile_kernel)
    monkeypatch.setattr(tbf, "knn_bcap", tile_kernel)
    monkeypatch.setattr(tbf, "knn_fold", counted_fold)
    profiling.reset_counters()
    dist, ids = tbf.knn_prepadded(pp, pn, qs, k, n, mu, scheme=scheme)
    assert folds == [(q, k_scan)]
    assert "route.repaired" not in profiling.counters()
    assert profiling.counters()["route.queries"] == q
    want = torch.sort(torch.cdist(qs.double(), pts.double()), dim=1)
    assert torch.allclose(dist.double(), want.values[:, :k], rtol=1e-5)
    assert torch.equal(ids.long(), want.indices[:, :k])


@pytest.mark.parametrize("k", [3, 10])
@pytest.mark.parametrize("q", [1, 4, 16])
@pytest.mark.parametrize("d", [7, 128])
@pytest.mark.parametrize("scheme", ["bcap", "capped"])
def test_few_route_answers_equal_the_proof_route(scheme, d, q, k,
                                                 monkeypatch):
    """The fold route at a few-query shape gives the distances of the
    route it replaces, the tile kernels' candidates (their plain versions)
    with the proof and the repair, bit for bit; the ids are equal but
    where two rows tie at the k-th distance."""
    n = 4000
    _, qs, mu, pp, pn = _route_inputs(1000 * d + 10 * q + k, n, q, d)
    profiling.reset_counters()
    old_d, old_i = tbf.knn_prepadded(pp, pn, qs, k, n, mu, scheme=scheme)
    assert profiling.counters()["route.queries"] == q
    monkeypatch.setattr(tbf, "_few_takes_fold", _rule_on_cpu)
    new_d, new_i = tbf.knn_prepadded(pp, pn, qs, k, n, mu, scheme=scheme)
    assert torch.equal(new_d, old_d)
    below = new_d < new_d[:, -1:]
    assert torch.equal(torch.sort(torch.where(below, new_i, -1), 1).values,
                       torch.sort(torch.where(below, old_i, -1), 1).values)
    for row in new_i.tolist():
        assert min(row) >= 0 and len(set(row)) == k
