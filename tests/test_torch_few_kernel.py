"""The few-query kernel's plain version and its rule (``knn_few``,
``few_path``; ``csrc/knn_few.cu`` runs on the card only): exact selection
against fold's plain version and a float64 oracle, the threshold of the
capped and bcap contracts, the FP32 tier's proof bound under the
tensor-core one, and the route's proof over the kernel's contracts.

Tolerance: the ids' float64 distances against the oracle's k smallest
within the FP32 tier's bound (the plain version's matmul sums in another
order than the oracle)."""

import math

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
    qn = torch.sum(qt.double() ** 2, dim=1)
    xn = torch.where(torch.isfinite(pn), pn, 0).max().double()
    return tbf._proof_err(d, qn, xn)


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


@pytest.mark.parametrize("k", [3, 18])
@pytest.mark.parametrize("d", [7, 128])
@pytest.mark.parametrize("q", [1, 4, 16])
@pytest.mark.parametrize("mode", ["capped", "bcap"])
def test_threshold_bounds_every_left_out(mode, q, d, k):
    """capped and bcap modes: thr is the k-th kept rdist, and every row
    (bcap: every 16-row block's minimum) left out has rdist at or above it
    in the same arithmetic; thr is NaN for a NaN query."""
    pp, pn, qt = _index(7 * q + d + k, 1000, q, d)
    rd, ids, thr = kk.knn_few(pp, qt, pn, k=k, mode=mode)
    qn = torch.sum(qt * qt, dim=1)
    u = kk._u(pp, qt, pn, 0, pp.shape[0])
    u = torch.where(torch.isnan(u), torch.inf, u)
    if mode == "bcap":
        u = torch.amin(u.reshape(q, -1, kk.BCAP_BLOCK), dim=2)
    full = u + qn[:, None]
    nanq = torch.isnan(qt).any(dim=1)
    assert bool(torch.isnan(thr[nanq]).all())
    for r in torch.nonzero(~nanq).flatten().tolist():
        kept = ids[r][ids[r] >= 0].long()
        assert kept.numel() == k
        assert torch.equal(torch.sort(rd[r]).values,
                           torch.sort(torch.clamp_min(full[r, kept], 0)).values)
        assert float(thr[r]) == float(full[r, kept].max())
        out = torch.ones(full.shape[1], dtype=torch.bool)
        out[kept] = False
        assert bool((full[r, out] >= thr[r]).all())


def test_threshold_is_inf_below_k_finite_rows():
    """Fewer than k finite rows (or blocks): the set keeps them all, the
    other slots are (+inf, -1), and thr is +inf."""
    pp, pn, qt = _index(3, 30, 2, 8, nan_query=False)
    for mode, k in (("capped", 40), ("bcap", 3)):
        rd, ids, thr = kk.knn_few(pp, qt, pn, k=k, mode=mode)
        assert bool(torch.isinf(thr).all())
        assert bool((ids == -1).any(dim=1).all())
        assert torch.equal(ids < 0, torch.isinf(rd))


def test_bcap_mode_keeps_the_smallest_block_minima():
    """bcap mode's ids are the blocks of the k smallest float64 block
    minima (within the FP32 bound), its rdist their minima."""
    pp, pn, qt = _index(11, 3000, 3, 128, nan_query=False)
    k = 18
    rd, ids, _ = kk.knn_few(pp, qt, pn, k=k, mode="bcap")
    b = kk.BCAP_BLOCK
    rd64 = _rd64(pp, pn, qt)
    rows = pp.shape[0] // b * b
    bmin = torch.amin(rd64[:, :rows].reshape(3, -1, b), dim=2)
    want = torch.sort(bmin, dim=1).values[:, :k]
    got = torch.sort(torch.gather(bmin, 1, ids.long()), dim=1).values
    err = _fp32_err(128, qt, pn)[:, None]
    assert bool(((got - want).abs() <= err).all())
    assert bool(((torch.sort(rd, 1).values.double() - got).abs() <= err).all())


def test_fp32_bound_under_tensor_core_bound_at_every_width():
    """The soundness argument of the capped and bcap routes over the
    few-query kernel: its u is on the FP32 tier, whose bound (4 + d/2)
    2^-23 (|q|^2 + max |x|^2) lies at or under the tensor-core tier's
    (4 + 12 ceil(d/16)) 2^-23 (...), which the route's proof uses, at
    every d from 1 to 4096."""
    qn = torch.tensor([1.0, 1e6])
    for d in range(1, 4097):
        fp32 = tbf._proof_err(d, qn, 3.0)
        tc = tbf._proof_err(d, qn, 3.0, tier="tc")
        assert bool((fp32 <= tc).all()), d
        assert math.isclose(float(fp32[0]), (4 + d / 2) * 2.0 ** -23 * 4.0)


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
    """The wrappers refuse an unknown path or mode and k past the kernel's
    limit before they run; on CPU tensors they run their plain versions
    whatever the rule says."""
    pp, pn, qt = _index(5, 500, 2, 8)
    with pytest.raises(ValueError, match="path"):
        kk.knn_fold(pp, qt, pn, k=4, path="wide")
    with pytest.raises(ValueError, match="path"):
        kk.knn_capped(pp, qt, pn, k=4, tile=64, passes=2, path="stream")
    with pytest.raises(ValueError, match="path"):
        kk.knn_bcap(pp, qt, pn, k=4, tile=8, passes=2, path="select")
    with pytest.raises(ValueError, match="mode"):
        kk.knn_few(pp, qt, pn, k=4, mode="merge")
    with pytest.raises(ValueError):
        kk.knn_few(pp, qt, pn, k=kk.FEW_K_MAX + 1)
    before = kk.knn_few.launches
    rd, ids, thr = kk.knn_capped(pp, qt, pn, k=4, tile=64, passes=2,
                                 path="few")
    crd, cids, cthr = kk.knn_capped_reference(pp, qt, pn, k=4, tile=64,
                                              passes=2)
    assert torch.equal(rd, crd) and torch.equal(ids, cids)
    assert kk.knn_few.launches == before


@pytest.mark.parametrize("scheme", ["capped", "bcap"])
@pytest.mark.parametrize("d", [8, 128])
def test_route_proof_over_the_few_contracts(scheme, d, monkeypatch):
    """The route's proof and repair unchanged, with the kernel's capped
    and bcap contracts (its plain version) in place of the tile kernels:
    exact answers against the float64 oracle, and no query repaired (the
    k-th neighbour lies far under the exact k_scan-th minus the bound)."""
    def capped(p, q, xn, *, k, tile, passes):
        return kk.knn_few_reference(p, q, xn, k=k, mode="capped")

    def bcap(p, q, xn, *, k, tile, passes):
        return kk.knn_few_reference(p, q, xn, k=k, mode="bcap")

    monkeypatch.setattr(tbf, "knn_capped", capped)
    monkeypatch.setattr(tbf, "knn_bcap", bcap)
    rng = np.random.default_rng(d)
    pts = torch.from_numpy(rng.random((5000, d)).astype(np.float32) * 50)
    qs = torch.from_numpy(rng.random((6, d)).astype(np.float32) * 50)
    mu, pp, pn, _ = tbf.prepare_euclidean_index(pts)
    profiling.reset_counters()
    dist, ids = tbf.knn_prepadded(pp, pn, qs, 10, 5000, mu, scheme=scheme)
    assert profiling.counters().get("route.repaired", 0) == 0
    want = torch.sort(torch.cdist(qs.double(), pts.double()), dim=1)
    assert torch.allclose(dist.double(), want.values[:, :10], rtol=1e-5)
    assert torch.equal(ids.long(), want.indices[:, :10])
