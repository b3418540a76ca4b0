"""The tensor-core tier of the port (the split-bf16 product of the capped
and merge kernels), as it runs on the CPU: the three-piece split, the
plain product ``_u_tc`` and the card's accumulation order (one float32
rounding per piece product per 16-feature step, ``_u_core_order``) against
f64 within its proof bound, the integrity
check and its ``RuntimeError``, the capped and merge plain versions on
``_u_tc`` against the JAX kernels at ``precision="highest"`` in interpret
mode, and the merge's layout (merge's edge rows are in
test_torch_knn_kernel.py, the capped route's proof in
test_torch_bruteforce.py).

Tolerances: the split is exact (bit for bit); u within ``tc_proof_err``
(derived in its docstring); rdist against the JAX kernels
rtol 2e-4 after sorting (the two sum the dot product in different orders;
the JAX kernel tests' own tolerance), ids as sets except where the k-th
and (k+1)-th exact distances lie within the tier's bound of each other."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops.bruteforce import pad_for_pallas as jax_pad
from petal_neighbors_tpu.ops.pallas.knn_kernel import knn_pallas
from petal_neighbors_tpu_torch.ops import bruteforce as bf
from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk


# ---- the split ------------------------------------------------------------

@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, -50), (-50, 0), (0, 50),
                                           (50, 100)])
def test_split_is_exact(lo_exp, hi_exp):
    """hi + mid + lo == x bit for bit over float32 values with exponents in
    [lo_exp, hi_exp], both signs; each piece is a bf16 value."""
    rng = np.random.default_rng(lo_exp + 1000)
    mant = rng.uniform(1.0, 2.0, 200_000)
    exp = rng.integers(lo_exp, hi_exp + 1, 200_000)
    sign = rng.choice([-1.0, 1.0], 200_000)
    x = torch.from_numpy((sign * np.ldexp(mant, exp)).astype(np.float32))
    hi, mid, lo = kk.split_bf16x3(x)
    for piece in (hi, mid, lo):
        assert torch.equal(piece.to(torch.bfloat16).float(), piece)
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi + (mid + lo), x)


def test_split_pieces_shrink():
    """|mid| <= 2^-8 |x| and |lo| <= 2^-16 |x|: the dropped ml, lm and ll
    products are at most 2^-23 |q_i x_i| together."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-8, 8, 100_000)))
                         .astype(np.float32))
    hi, mid, lo = kk.split_bf16x3(x)
    assert bool((mid.abs() <= 2.0 ** -8 * x.abs()).all())
    assert bool((lo.abs() <= 2.0 ** -16 * x.abs()).all())


# ---- u and its bound ------------------------------------------------------

@pytest.mark.parametrize("d", [128, 960])
def test_u_tc_within_bound_of_f64(d):
    """``_u_tc`` on the probe distribution (standard_normal x
    exp(uniform(-8, 8)), plus large rows against small queries) within
    ``tc_proof_err`` of the f64 u on the same float32 inputs."""
    pts, qs = kk._probe_inputs(d)
    p, q = torch.from_numpy(pts), torch.from_numpy(qs)
    xn = torch.sum(p * p, dim=1)
    u = kk._u_tc(p, q, xn, 0, p.shape[0])
    u64 = xn.double()[None, :] - 2.0 * (q.double() @ p.double().T)
    bound = kk.tc_proof_err(d, torch.sum(q * q, 1).double(),
                            xn.double().max())[:, None]
    assert bool(((u.double() - u64).abs() <= bound).all())


#: the piece products in the order the card's core issues them each k-step
#: (csrc/knn_tc.cuh ``issue``): hh, hm, mh, hl, lh, mm as (query piece,
#: point piece)
_PRODUCT_ORDER = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _u_core_order(points, queries, point_norms):
    """u as the card's core accumulates it: features zero-padded to a
    multiple of 16; for each 16-feature k-step in ascending order, the six
    piece products in ``_PRODUCT_ORDER``, each adding the exact sum of its
    16 piece products (bf16 x bf16 is exact; summed in float64) to the
    float32 accumulator with one float32 rounding; then u = ||x||^2 -
    2 acc in float32."""
    pad = (-points.shape[1]) % 16
    qp = [t.double() for t in kk.split_bf16x3(
        torch.nn.functional.pad(queries, (0, pad)))]
    xp = [t.double() for t in kk.split_bf16x3(
        torch.nn.functional.pad(points, (0, pad)))]
    acc = torch.zeros((queries.shape[0], points.shape[0]),
                      dtype=torch.float32)
    for k0 in range(0, points.shape[1] + pad, 16):
        for a, b in _PRODUCT_ORDER:
            step = qp[a][:, k0:k0 + 16] @ xp[b][:, k0:k0 + 16].T
            acc = (acc.double() + step).float()
    return point_norms[None, :] - 2.0 * acc


@pytest.mark.parametrize("d", [2, 100, 128, 960])
def test_core_accumulation_order_within_bound(d):
    """The core's accumulation order (one float32 rounding per product per
    16-feature step, ``_u_core_order``) on the probe distribution stays
    within ``tc_proof_err`` of the f64 u at one k-step (d = 2), at a width
    no multiple of 16 (d = 100) and at the cells' 128 and 960."""
    pts, qs = kk._probe_inputs(d)
    p, q = torch.from_numpy(pts), torch.from_numpy(qs)
    xn = torch.sum(p * p, dim=1)
    u = _u_core_order(p, q, xn)
    u64 = xn.double()[None, :] - 2.0 * (q.double() @ p.double().T)
    bound = kk.tc_proof_err(d, torch.sum(q * q, 1).double(),
                            xn.double().max())[:, None]
    assert bool(((u.double() - u64).abs() <= bound).all())
    # the order is not the only one within the bound: the plain product's
    # float32 sums of whole matmuls lie within it too
    u_plain = kk._u_tc(p, q, xn, 0, p.shape[0])
    assert bool(((u_plain.double() - u64).abs() <= bound).all())


def test_proof_err_tiers():
    """``tc_proof_err``, the bound every proof-gated route proves on, is
    (4 + 12 ceil(d/16)) 2^-23 (|q|^2 + max |x|^2), and the route's module
    proves on that function itself."""
    qn = torch.tensor([2.0, 3.0])
    assert bf.tc_proof_err is kk.tc_proof_err
    for d in (1, 5, 16, 17, 100, 128, 960):
        tc = kk.tc_proof_err(d, qn, 1.5)
        assert torch.allclose(tc, (4 + 12 * math.ceil(d / 16)) * 2.0 ** -23
                              * (qn + 1.5))


def test_integrity_check_passes_and_raises():
    """The probe's check passes the plain product and raises RuntimeError
    on a product that breaks the bound (a single bf16 pass, the error a
    lost split would give), with no warning-and-continue."""
    ratio = kk.check_tc_product(
        lambda p, q, xn: kk._u_tc(p, q, xn, 0, p.shape[0]), "cpu")
    assert 0.0 <= ratio <= 1.0

    def one_pass(p, q, xn):
        return xn[None, :] - 2.0 * (q.to(torch.bfloat16).float()
                                    @ p.to(torch.bfloat16).float().T)
    with pytest.raises(RuntimeError, match="proof bound"):
        kk.check_tc_product(one_pass, "cpu")


def test_integrity_check_over_block_minima():
    """The probe's check over 16-row block minima (the form in which it
    holds ``tc::scan_minima``): the plain block minima on the tier pass,
    and the minima of a single bf16 pass raise RuntimeError naming the
    product checked."""
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

    ratio = kk.check_tc_product(mk.bcap_minima_reference, "cpu",
                                kk.BCAP_BLOCK, "scan_minima")
    assert 0.0 <= ratio <= 1.0

    def one_pass(p, q, xn):
        u = xn[None, :] - 2.0 * (q.to(torch.bfloat16).float()
                                 @ p.to(torch.bfloat16).float().T)
        return torch.amin(u.reshape(u.shape[0], -1, kk.BCAP_BLOCK), dim=2)
    with pytest.raises(RuntimeError, match="proof bound.*scan_minima"):
        kk.check_tc_product(one_pass, "cpu", kk.BCAP_BLOCK, "scan_minima")


# ---- capped and merge on the tier against the JAX kernels -----------------

def _inputs(seed, n, d, q):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    pts[[7, n // 2]] = np.nan
    qs[[3, q - 1]] = np.nan
    pp, pn = jax_pad(jnp.asarray(pts), tn=2048)
    return pts, qs, pp, pn


def _tied(pts, q, k, d):
    """The k-th and (k+1)-th exact squared distances lie within twice the
    tier's bound of each other (either may come first)."""
    ok = ~np.isnan(pts).any(axis=1)
    p64 = pts[ok].astype(np.float64)
    dist = np.sort(((p64 - q) ** 2).sum(1))
    band = 2 * float(kk.tc_proof_err(d, float((q * q).sum()),
                                     float((p64 * p64).sum(1).max())))
    return k < len(dist) and dist[k] - dist[k - 1] <= max(band,
                                                          2e-4 * dist[k])


@pytest.mark.parametrize("d,k,passes", [(128, 18, 2), (128, 108, 4),
                                        (960, 18, 2)])
def test_capped_reference_matches_jax_highest(d, k, passes):
    """``knn_capped_reference`` (on ``_u_tc``) against
    ``knn_pallas(scheme="capped", precision="highest", interpret=True)`` on
    the same padded arrays, NaN rows and queries included: rdist and thr
    within rtol 2e-4, ids equal as sets but at boundary ties."""
    pts, qs, pp, pn = _inputs(d + k, 4096, d, 16)
    jd, ji, jt = (np.asarray(a) for a in knn_pallas(
        pp, jnp.asarray(qs), pn, k=k, tq=8, tn=2048, interpret=True,
        precision="highest", scheme="capped", passes=passes))
    td, ti, tt = (t.numpy() for t in kk.knn_capped_reference(
        torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
        torch.from_numpy(np.array(pn)), k=k, tile=2048, passes=passes))
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isnan(tt[nanq]).all()
    np.testing.assert_allclose(np.sort(td[~nanq], 1), np.sort(jd[~nanq], 1),
                               rtol=2e-4)
    np.testing.assert_allclose(tt[~nanq], jt[~nanq], rtol=2e-4)
    for r in np.flatnonzero(~nanq):
        if not _tied(pts, qs[r].astype(np.float64), k, d):
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r


@pytest.mark.parametrize("d,k", [(128, 1100), (960, 700)])
def test_merge_reference_matches_jax_highest(d, k):
    """``knn_merge_reference`` (on ``_u_tc``) against ``knn_pallas(scheme=
    "merge", precision="highest", interpret=True)``: rows ascending, rdist
    within rtol 2e-4, ids as sets but at boundary ties, NaN rows and
    queries included."""
    pts, qs, pp, pn = _inputs(d + k, 4096, d, 16)
    jd, ji = (np.asarray(a) for a in knn_pallas(
        pp, jnp.asarray(qs), pn, k=k, tq=8, tn=2048, interpret=True,
        precision="highest", scheme="merge", sort_output=False))
    td, ti = (t.numpy() for t in kk.knn_merge_reference(
        torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
        torch.from_numpy(np.array(pn)), k=k))
    nanq = np.isnan(qs).any(axis=1)
    assert (ti[nanq] == -1).all() and np.isposinf(td[nanq]).all()
    assert (np.diff(td[~nanq], axis=1) >= 0).all()
    np.testing.assert_allclose(td[~nanq], np.sort(jd[~nanq], 1), rtol=2e-4)
    for r in np.flatnonzero(~nanq):
        if not _tied(pts, qs[r].astype(np.float64), k, d):
            assert set(ti[r].tolist()) == set(ji[r].tolist()), r


# ---- the merge's layout and the wrappers ----------------------------------

@pytest.mark.parametrize("n,k,glog,width", [
    (1_000_000, 3072, 7, 6144), (1_000_000, 4096, 7, 8192),
    (1_000_000, 1100, 7, 2200), (70001, 3000, 4, 6000),
    (1203, 1100, 4, 2200), (1_000_000, 700, 7, 1724)])
def test_merge_layout(n, k, glog, width):
    """Groups of 2^glog rows: the widest of 128..16 with at least 1.5 k
    groups (else 16); lists of min(8192, k + max(k, 1024)) words."""
    assert kk.merge_layout(n, k) == (glog, width)
    assert width >= k and width <= 8192


def test_tc_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors capped and merge run their plain versions on the
    tensor-core tier's u, count no launch and never probe a card."""
    pts, qs, pp, pn = _inputs(1, 4096, 64, 16)
    args = (torch.from_numpy(np.array(pp)), torch.from_numpy(qs),
            torch.from_numpy(np.array(pn)))
    before = (kk.knn_capped.launches, kk.knn_merge.launches, dict(kk._probed))
    a = kk.knn_capped(*args, k=10, tile=2048, passes=2)
    b = kk.knn_capped_reference(*args, k=10, tile=2048, passes=2)
    for x, y in zip(a, b):
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
    m = kk.knn_merge(*args, k=700)
    r = kk.knn_merge_reference(*args, k=700)
    assert torch.equal(m[0], r[0]) and torch.equal(m[1], r[1])
    assert (kk.knn_capped.launches, kk.knn_merge.launches,
            kk._probed) == before
