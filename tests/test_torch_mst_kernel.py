"""The port's Borůvka scan-round kernel (``ops/cuda/mst_kernel.py``) as it
runs on the CPU, its plain PyTorch version, against the JAX package's
``_scan_minout`` and ``_scan_round`` on shared numpy inputs.

Tolerance.  On small-integer coordinates and cores every difference,
square and sum is exact in f32, so the minima (bw), their rows (bj) and
the round's winners are equal bit for bit, ties included: the lowest j
wins within a tile and a strict "<" across tiles, in both.  On real-valued
data the port's float32 step is the fused ``fma(t, t, acc)``, rounded once
(held here to glibc's ``fmaf`` and to a per-pair float64 emulation bit for
bit), where XLA's CPU jit may or may not contract ``acc + t*t``, so bw
agrees with the JAX side within 2·d f32 ulp and bj wherever the runner-up
is farther than that; the round's weights likewise.  The JAX side runs its
own tiling with small chunks (qchunk 32, nchunk 64), so ragged
tiles on both axes are crossed."""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.trees import boruvka as jb
from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as mk
from petal_neighbors_tpu_torch.trees import boruvka as tb

QCHUNK, NCHUNK = 32, 64


def _inputs(seed, n, d, *, labels="few", integer=True, inf_core=False,
            nq=None, dtype=np.float32):
    """(pts, core_rd, comp, q, cq_rd, compq) as numpy: duplicated rows,
    optionally +inf cores, labels all distinct, three large components or
    one; the query rows are the corpus or ``nq`` rows of their own."""
    rng = np.random.default_rng(seed)

    def rows(m):
        return (rng.integers(-4, 5, size=(m, d)) if integer
                else rng.standard_normal((m, d))).astype(dtype)
    pts = rows(n)
    if n > 10:
        pts[5:9] = pts[2]
    core = (rng.integers(0, 4, size=n) if integer
            else rng.random(n) * 0.5).astype(dtype)
    core_rd = core * core
    if inf_core:
        core_rd[::5] = np.inf
    comp = {"distinct": np.arange(n), "few": rng.integers(0, 3, size=n),
            "one": np.zeros(n)}[labels].astype(np.int32)
    if nq is None:
        return pts, core_rd, comp, pts, core_rd, comp
    pick = rng.integers(0, n, size=nq)
    return pts, core_rd, comp, rows(nq), core_rd[pick], comp[pick]


def _jax(arrays):
    bw, bj = jb._scan_minout(*(jnp.asarray(a) for a in arrays),
                             qchunk=QCHUNK, nchunk=NCHUNK)
    return np.asarray(bw), np.asarray(bj)


def _port(arrays):
    bw, bj = mk.scan_minout(*(torch.from_numpy(a) for a in arrays))
    return bw.numpy(), bj.numpy()


CASES = [
    dict(n=137, d=4, labels="few"),
    dict(n=64, d=2, labels="distinct"),
    dict(n=65, d=3, labels="few", inf_core=True),
    dict(n=200, d=8, labels="distinct", inf_core=True),
    dict(n=150, d=17, labels="few", nq=70),
    dict(n=129, d=3, labels="one"),
    dict(n=1, d=2, labels="distinct"),
    dict(n=300, d=5, labels="few", dtype=np.float64),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{getattr(v, '__name__', v)}" for k, v in c.items()))
def test_scan_minout_matches_jax_bit_for_bit_on_integer_data(case):
    arrays = _inputs(3, **case)
    jw, jj = _jax(arrays)
    tw, tj = _port(arrays)
    assert tw.dtype == jw.dtype and tj.dtype == np.int32
    np.testing.assert_array_equal(tw.view(f"i{tw.itemsize}"),
                                  jw.view(f"i{jw.itemsize}"))
    np.testing.assert_array_equal(tj, jj)
    # no finite weight without a row, no row without one
    assert np.array_equal(np.isfinite(tw), tj >= 0)
    if case["labels"] == "one":
        assert np.isinf(tw).all() and (tj == -1).all()


def test_scan_minout_keeps_the_lowest_row_at_a_tie():
    # every corpus row at the same place and core: all weights tie, so each
    # query takes the lowest row of another label
    n = 150
    pts = np.zeros((n, 3), np.float32)
    core_rd = np.ones(n, np.float32)
    comp = (np.arange(n) // 40).astype(np.int32)
    arrays = (pts, core_rd, comp, pts, core_rd, comp)
    tw, tj = _port(arrays)
    want = np.where(comp == 0, 40, 0)
    np.testing.assert_array_equal(tj, want)
    np.testing.assert_array_equal(tj, _jax(arrays)[1])
    assert (tw == 1.0).all()


@pytest.mark.parametrize("d", [3, 8, 17])
def test_scan_minout_matches_jax_within_ulp_on_real_data(d):
    arrays = _inputs(4, 300, d, integer=False, labels="few")
    jw, jj = _jax(arrays)
    tw, tj = _port(arrays)
    tol = 2 * d * np.spacing(np.maximum(np.abs(jw), 1e-30)).astype(np.float64)
    assert np.all(np.abs(tw.astype(np.float64) - jw) <= tol)
    # ids may differ only where the runner-up lies within the tolerance
    pts, core_rd, comp = arrays[:3]
    rd = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    w = np.maximum(np.maximum(rd, core_rd[:, None]), core_rd[None, :])
    w[comp[:, None] == comp[None, :]] = np.inf
    for i in np.flatnonzero(tj != jj):
        assert abs(w[i, tj[i]] - w[i, jj[i]]) <= 2 * tol[i]


def test_scan_minout_reference_tiling_changes_nothing():
    arrays = [torch.from_numpy(a) for a in _inputs(5, 333, 6, labels="few",
                                                   inf_core=True, nq=97)]
    a = mk.scan_minout_reference(*arrays)
    b = mk.scan_minout_reference(*arrays, qchunk=7, nchunk=19)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("labels", ["few", "distinct", "one"])
def test_scan_round_matches_jax(labels):
    n = 137
    pts, _, comp = _inputs(6, n, 4, labels=labels)[:3]
    core = np.random.default_rng(6).integers(0, 4, size=n).astype(np.float32)
    je = jb._scan_round(jnp.asarray(pts), jnp.asarray(core),
                        jnp.asarray(comp), qchunk=QCHUNK, nchunk=NCHUNK)
    te = tb._scan_round(torch.from_numpy(pts), torch.from_numpy(core),
                        torch.from_numpy(comp))
    for j, t in zip(je, te):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if labels == "one":
        assert (te[0] == -1).all() and torch.isinf(te[2]).all()


def test_cpu_runs_plain_version_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _inputs(7, 100, 3)]
    before = mk.scan_minout.launches
    a = mk.scan_minout(*arrays)
    b = mk.scan_minout_reference(*arrays)
    assert mk.scan_minout.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_scan_minout_rejects_bad_inputs():
    pts, core_rd, comp, q, cq_rd, compq = (torch.from_numpy(a) for a in
                                           _inputs(8, 20, 3))
    with pytest.raises(TypeError):
        mk.scan_minout(pts, core_rd.double(), comp, q, cq_rd, compq)
    with pytest.raises(TypeError):
        mk.scan_minout(pts, core_rd, comp.long(), q, cq_rd, compq)
    with pytest.raises(TypeError):
        mk.scan_minout(pts.half(), core_rd.half(), comp, q.half(),
                       cq_rd.half(), compq)
    with pytest.raises(ValueError):
        mk.scan_minout(pts, core_rd, comp, q[:, :2], cq_rd, compq)
    with pytest.raises(ValueError):
        mk.scan_minout(pts, core_rd[:5], comp, q, cq_rd, compq)


def _pairs(seed, m):
    """(t, acc) float32 pairs for the fused step: t*t and acc at equal
    exponents and up to 40 binades apart (either larger), either sign of
    acc, zeros, sums near overflow (t*t to 2^128) and past it (t*t to
    2^132), near the subnormals (t*t from 2^-150, subnormal acc),
    infinite t or acc, and ties: t*t halfway between two float32 values
    (an odd t of 13 bits) with an acc below its float64 rounding, where a
    float64 sum rounded to float32 goes the wrong way."""
    rng = np.random.default_rng(seed)

    def mant(k):
        return 1.0 + rng.random(k)
    k = m // 6
    et = rng.integers(-60, 61, size=3 * k)
    spread = np.concatenate([np.zeros(k, int), rng.integers(-40, 41, 2 * k)])
    t = np.ldexp(mant(3 * k), et)
    acc = np.ldexp(mant(3 * k), np.clip(2 * et + spread, -140, 126)) \
        * rng.choice([-1.0, 1.0], 3 * k)
    big_t = np.ldexp(mant(k), rng.integers(62, 66, k))
    big_a = np.ldexp(mant(k), rng.integers(100, 127, k))
    tiny_t = np.ldexp(mant(k), rng.integers(-76, -68, k))
    tiny_a = np.ldexp(rng.random(k), rng.integers(-149, -124, k))
    e = rng.integers(-60, 41, k)
    tie_t = np.ldexp(rng.integers(2048, 2896, k) * 2.0 + 1.0, e)
    tie_a = np.ldexp(mant(k), 2 * e - 31 - rng.integers(0, 41, k)) \
        * rng.choice([-1.0, 0.0, 1.0], k, p=[0.45, 0.1, 0.45])
    t = np.concatenate([t, big_t, tiny_t, tie_t]).astype(np.float32)
    acc = np.concatenate([acc, big_a, tiny_a, tie_a]).astype(np.float32)
    zero = rng.random(t.shape[0])
    t[zero < 0.01] = 0.0
    acc[(zero > 0.01) & (zero < 0.02)] = 0.0
    acc[(zero > 0.02) & (zero < 0.025)] = np.inf
    acc[(zero > 0.025) & (zero < 0.03)] = -np.inf
    t[(zero > 0.03) & (zero < 0.035)] = np.inf      # acc finite: +inf
    t[(zero > 0.035) & (zero < 0.04)] = -np.inf
    return t, acc


def test_fused_step_equals_glibc_fmaf():
    fmaf = ctypes.CDLL("libm.so.6").fmaf
    fmaf.argtypes = [ctypes.c_float] * 3
    fmaf.restype = ctypes.c_float
    t, acc = _pairs(18, 120_000)
    want = np.array([fmaf(a, a, b) for a, b in zip(t.tolist(), acc.tolist())],
                    np.float32)
    got = mk._fma_rn(torch.from_numpy(t), torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the pairs reach the cases a separately rounded step gets wrong, those
    # a float64 sum rounded to float32 gets wrong, and both ends of the
    # range, infinities included
    with np.errstate(over="ignore", invalid="ignore"):
        unfused = (t * t) + acc
        twice = (t.astype(np.float64) ** 2 + acc).astype(np.float32)
    assert (unfused.view(np.int32) != want.view(np.int32)).sum() > 1000
    assert (twice.view(np.int32) != want.view(np.int32)).sum() > 1000
    assert np.isinf(acc).any() and np.isinf(t).any()
    assert np.isinf(want[np.isfinite(t) & np.isfinite(acc)]).any()
    assert (np.abs(want) < 2.0 ** -126).any() and not np.isnan(want).any()


def _np_fused(t, acc):
    """fma(t, t, acc) in numpy: the float64 sum, its TwoSum error, one
    step of the float64 bits toward it where the last bit is even (round
    to odd), then float32."""
    p = t.astype(np.float64) ** 2
    a = acc.astype(np.float64)
    s = p + a
    z = s - p
    err = (p - (s - z)) + (a - z)
    bits = s.view(np.int64)
    step = np.where(np.signbit(err) == np.signbit(s), 1, -1)
    bits = np.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return bits.view(np.float64).astype(np.float32)


def _np_scan(arrays, fused=True):
    """(bw, bj) pair by pair: the float32 sum over the features in order
    (fused steps, or each product and sum rounded), then the mask, the
    least w and its first j."""
    pts, core_rd, comp, q, cq_rd, compq = arrays
    acc = None
    for f in range(pts.shape[1]):
        t = q[:, f, None] - pts[None, :, f]
        acc = (t * t if acc is None
               else _np_fused(t, acc) if fused else acc + t * t)
    w = np.maximum(np.maximum(acc, cq_rd[:, None]), core_rd[None, :])
    w[compq[:, None] == comp[None, :]] = np.inf
    bj = np.argmin(w, axis=1).astype(np.int32)
    bw = w[np.arange(w.shape[0]), bj]
    return bw, np.where(np.isfinite(bw), bj, -1).astype(np.int32)


@pytest.mark.parametrize("d", [2, 8, 17])
def test_scan_minout_reference_is_the_fused_sum_on_real_data(d):
    pts, core_rd, comp, _, _, _ = _inputs(9, 260, d, integer=False,
                                          labels="few", inf_core=True)
    scale = np.exp2(np.random.default_rng(d).integers(-6, 7, size=pts.shape))
    pts = (pts * scale).astype(np.float32)
    rng = np.random.default_rng(10 + d)
    pick = rng.integers(0, 260, size=90)
    arrays = (pts, core_rd, comp, (pts[pick] + rng.standard_normal(
        (90, d)).astype(np.float32)), core_rd[pick], comp[pick])
    bw, bj = mk.scan_minout_reference(*(torch.from_numpy(a) for a in arrays),
                                      qchunk=32, nchunk=64)
    want_w, want_j = _np_scan(arrays)
    np.testing.assert_array_equal(bw.numpy().view(np.int32),
                                  want_w.view(np.int32))
    np.testing.assert_array_equal(bj.numpy(), want_j)
    # a separately rounded sum gives other bits on this data
    unfused = _np_scan(arrays, fused=False)[0]
    assert (unfused.view(np.int32) != want_w.view(np.int32)).any()
