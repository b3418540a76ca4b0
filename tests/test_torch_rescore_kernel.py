"""The direct-form rescore (``ops.cuda.rescore_kernel``): ``rescore_rd``'s
plain version against the rescore helpers as they were written in eager
PyTorch before it (``_eager_*`` below: ``rescore_exact``, ``_rescore``,
``_rescore_large``, ``_block_rd``, each its own gather, difference and
sum), bit for bit, and the helpers that now call it against the
same; the launch plan and the rounding bound.

The tests marked ``card`` run the kernel on a card and skip without one:
``python -m pytest --noconftest -m card tests/test_torch_rescore_kernel.py``
on a machine with a card (``--noconftest``: the suite's conftest imports
JAX, which that machine lacks; this file does not import it).  They hold
``csrc/rescore.cu`` to a float64 sum of the same rounded differences'
squares within ``rescore_rounding``, its +inf pattern to the plain
version's exactly, and count its launches and the counter
``rescore.pairs``."""

import numpy as np
import pytest
import torch

from petal_neighbors_tpu_torch.ops import bruteforce as bf
from petal_neighbors_tpu_torch.ops import topk
from petal_neighbors_tpu_torch.ops.cuda import rescore_kernel as rk
from petal_neighbors_tpu_torch.utils import profiling


# -- the helpers as they were, each its own gather, difference and sum ----

def _eager_rescore_exact(points, queries, idx, k):
    n = points.shape[0]
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0).long()
    diff = queries[..., None, :] - points[safe]
    rd = torch.sum(diff * diff, dim=-1)
    rd = torch.where(ok, topk.nan_to_inf(rd), torch.inf)
    return topk.smallest_k(rd, torch.where(ok, idx, -1), k), rd


def _eager_rescore(pts_padded, queries, idx, k_eff):
    q, dim = queries.shape
    rows = max(1, (1 << 26) // (max(idx.shape[1], 1) * dim))
    parts = [_eager_rescore_exact(pts_padded, queries[s:s + rows],
                                   idx[s:s + rows], k_eff)[0]
             for s in range(0, q, rows)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _eager_rescore_large(points, queries, idx, k):
    q, dim = queries.shape
    n = points.shape[0]
    k_in = idx.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0).long()
    rows = max(64, (1 << 24) // max(1, k_in * dim))
    rd = torch.empty((q, k_in), dtype=points.dtype, device=points.device)
    for s in range(0, q, rows):
        diff = queries[s:s + rows, None, :] - points[safe[s:s + rows]]
        rd[s:s + rows] = torch.sum(diff * diff, dim=-1)
    rd = torch.where(ok, topk.nan_to_inf(rd), torch.inf)
    row_sort = (bf.rank_sort_pairs if k_in > bf.BITONIC_WIDTH_MAX
                else bf.bitonic_sort_pairs)
    sd, si = row_sort(rd, torch.where(ok, idx, -1).to(torch.int32))
    return sd[:, :k], si[:, :k]


def _eager_block_rd(pts_padded, xn_padded, queries, block_ids, block):
    q, kb = block_ids.shape
    n_pad, dim = pts_padded.shape
    width = kb * block
    off = torch.arange(block, dtype=block_ids.dtype, device=block_ids.device)
    rows = (block_ids[:, :, None] * block + off).reshape(q, width)
    ok = (block_ids >= 0).repeat_interleave(block, dim=1) & (rows < n_pad)
    safe = torch.where(ok, rows, 0).long()
    ok &= torch.isfinite(xn_padded[safe])
    rd = torch.empty((q, width), dtype=pts_padded.dtype,
                     device=pts_padded.device)
    step = max(1, (1 << 26) // max(1, width * dim))
    for s in range(0, q, step):
        diff = queries[s:s + step, None, :] - pts_padded[safe[s:s + step]]
        rd[s:s + step] = torch.sum(diff * diff, dim=-1)
    return (torch.where(ok, topk.nan_to_inf(rd), torch.inf),
            torch.where(ok, rows, -1).to(torch.int32))


# -- inputs ---------------------------------------------------------------

def _case(block, d, id_dtype, dtype, q=7, width=None, seed=0):
    """Points with NaN rows (zeroed with +inf norms where ``block`` > 1, as
    ``pad_for_pallas`` leaves them; left NaN for id rescoring, as the flat
    ``knn`` and the trees hand them), a last block cut short, a NaN query,
    and ids that are valid, repeated, -1 and past the end."""
    rng = np.random.default_rng(seed + 1000 * block + d)
    n = {1: 200, 16: 200, 128: 448}[block]
    pts = (rng.standard_normal((n, d)) * 3.0 + 1.0).astype(dtype)
    pts[5] = np.nan
    pts[n - 2] = np.nan
    pts = torch.from_numpy(pts)
    norms = None
    if block > 1:
        pts, norms = bf.pad_for_pallas(pts, tn=1)
    qs = torch.from_numpy(rng.standard_normal((q, d)).astype(dtype))
    if q > 2:
        qs[2] = float("nan")
    n_ids = -(-n // block)
    width = width or (13 if block == 1 else 5)
    ids = rng.integers(0, n_ids, (q, width))
    ids[:, 0] = 5 // block
    if width > 2:
        ids[0, 1] = -1
        ids[-1, 2] = n_ids + 3
        ids[:, -1] = n_ids - 1                # the short last block
    if width > 3 and q > 1:
        ids[1, 3] = ids[1, 0]                 # a repeat
    return pts, norms, qs, torch.from_numpy(ids.astype(id_dtype))


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.nan_to_num(a, nan=-1.0), torch.nan_to_num(b, nan=-1.0))


# -- the plain version on the CPU -----------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("d", [2, 3, 100, 128, 256, 960])
@pytest.mark.parametrize("block", [1, 16, 128])
def test_plain_form_matches_eager_helpers(block, d, id_dtype, dtype):
    """``rescore_rd`` on CPU tensors gives the eager helpers' rdist bit for
    bit, and the helpers that call it give the eager answers: at block
    1 ``rescore_exact``, the route's ``_rerank`` below and above k_scan 512
    (the eager ``_rescore`` and ``_rescore_large``); at blocks 16 and
    128 ``_block_rd`` (its rows where the rdist is finite, -1 where it is
    +inf) and ``_block_rescore``, and at 16 ``_bcap_rescore_large``."""
    pts, norms, qs, ids = _case(block, d, id_dtype, dtype)
    rd = rk.rescore_rd(pts, qs, ids, block=block, norms=norms)
    if block == 1:
        (want_rd, want_i), want_all = _eager_rescore_exact(pts, qs, ids, 6)
        assert _bits_equal(rd, want_all)
        got_rd, got_i = topk.rescore_exact(pts, qs, ids, 6)
        assert _bits_equal(got_rd, want_rd) and torch.equal(got_i, want_i)
        got = bf._rerank(pts, qs, ids, 6, 13)
        want = _eager_rescore(pts, qs, ids, 6)
        assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if dtype == np.float32:
            got = bf._rerank(pts, qs, ids, 6, 512)
            want = _eager_rescore_large(pts, qs, ids, 6)
            assert _bits_equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        return
    want_rd, want_rows = _eager_block_rd(pts, norms, qs, ids, block)
    assert _bits_equal(rd, want_rd)
    got_rd, got_rows = bf._block_rd(pts, norms, qs, ids, block)
    assert _bits_equal(got_rd, want_rd)
    fin = torch.isfinite(got_rd)
    assert torch.equal(got_rows[fin], want_rows[fin])
    assert bool(torch.all(got_rows[~fin] == -1))
    k = 9
    got = bf._block_rescore(pts, norms, qs, ids, k, block)
    vals, best = topk.smallest_k(want_rd, want_rows, k)
    assert _bits_equal(got[0], vals)
    assert torch.equal(got[1], torch.where(torch.isfinite(vals), best, -1))
    if block == bf.BCAP_BLOCK and dtype == np.float32:
        got = bf._bcap_rescore_large(pts, norms, qs, ids, k)
        saved = bf._block_rd
        try:
            bf._block_rd = _eager_block_rd
            want = bf._bcap_rescore_large(pts, norms, qs, ids, k)
        finally:
            bf._block_rd = saved
        for a, b in zip(got, want):
            assert _bits_equal(a, b) if a.is_floating_point() else \
                torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block", [1, 16])
@pytest.mark.parametrize("q,width", [(1, 1), (1, 18), (6, 1)])
def test_plain_form_edges(q, width, block, dtype):
    """One query, one candidate: the same bits as the eager helpers."""
    pts, norms, qs, ids = _case(block, 128, np.int64, dtype, q=q,
                                width=width, seed=3)
    rd = rk.rescore_rd(pts, qs, ids, block=block, norms=norms)
    if block == 1:
        want = _eager_rescore_exact(pts, qs, ids, 1)[1]
    else:
        want = _eager_block_rd(pts, norms, qs, ids, block)[0]
    assert rd.shape == (q, width * block)
    assert _bits_equal(rd, want)


@pytest.mark.parametrize("block", [1, 16, 128])
def test_plain_chunks_do_not_move_bits(block, monkeypatch):
    """The plain version's query chunks change no bit: a chunk of one query
    gives the one-chunk answer."""
    pts, norms, qs, ids = _case(block, 100, np.int32, np.float32, q=9)
    whole = rk.rescore_rd(pts, qs, ids, block=block, norms=norms)
    monkeypatch.setattr(rk, "_PLAIN_ELEMS", 1)
    assert _bits_equal(rk.rescore_rd(pts, qs, ids, block=block, norms=norms),
                       whole)


def test_rescore_rd_checks_shapes():
    pts = torch.zeros((10, 4))
    with pytest.raises(ValueError):
        rk.rescore_rd(pts, torch.zeros((3, 5)), torch.zeros((3, 2),
                                                           dtype=torch.int32))
    with pytest.raises(ValueError):
        rk.rescore_rd(pts, torch.zeros((3, 4)), torch.zeros((2, 2),
                                                           dtype=torch.int32))
    with pytest.raises(ValueError):
        rk.rescore_rd(pts, torch.zeros((3, 4)),
                      torch.zeros((3, 2), dtype=torch.int32), block=0)


@pytest.mark.parametrize("q,rows,d", [
    (10_000, 1008, 256), (10_000, 1008, 128), (10_000, 288, 128),
    (10_000, 108, 128), (1_000, 18, 960), (10_000, 18, 100), (1, 18, 128),
    (1, 288, 960), (214, 1008, 128), (3, 5, 2), (1, 1, 0)])
def test_plan_covers_every_row(q, rows, d):
    """The launch covers each query's rows in whole passes, shares them
    evenly, keeps a block to at most ``_MAX_PASSES`` passes, and takes
    more than one only where every streaming multiprocessor still gets
    ``_BLOCKS_PER_SM`` blocks."""
    sms = 132
    lanes, tile_rows, tiles = rk.rescore_plan(q, rows, d, 4, d % 4 == 0, sms)
    step = rk.THREADS // lanes * rk.UNROLL
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert tile_rows % step == 0 and tile_rows // step <= rk._MAX_PASSES
    assert (tiles - 1) * tile_rows < rows <= tiles * tile_rows
    if tile_rows > step:
        assert q * tiles >= rk._BLOCKS_PER_SM * sms // 2


def test_plan_lanes_and_rounding():
    """Lanes a row and the stated rounding: a full warp from d = 128 in
    float32, 16 lanes at d = 100, 2 at d = 2 and 3; 37 units of 2^-24
    (2.2e-6) at d = 960, under the benchmark's 5e-6."""
    assert [rk.rescore_plan(1, 18, d, 4, d % 4 == 0, 132)[0]
            for d in (2, 3, 100, 128, 256, 960)] == [2, 2, 16, 32, 32, 32]
    assert rk.rescore_rounding(960, torch.float32, True) == 37 * 2.0 ** -24
    assert rk.rescore_rounding(960, torch.float32, True) < 5e-6
    assert rk.rescore_rounding(3, torch.float32, False) == 3 * 2.0 ** -24
    assert rk.rescore_rounding(128, torch.float64, True) == 9 * 2.0 ** -53


# -- the kernel on the card -----------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("d", [2, 3, 100, 128, 256, 960])
@pytest.mark.parametrize("block", [1, 16, 128])
def test_kernel_against_oracle(card, block, d, id_dtype, dtype):
    """The kernel within ``rescore_rounding`` of a float64 sum of the same
    rounded differences' squares (plus that sum's own rounding), its +inf
    exactly where the plain version's are, one launch and Q·W·block pairs
    counted."""
    pts, norms, qs, ids = _case(block, d, id_dtype, dtype, q=33)
    pts, qs, ids = pts.to(card), qs.to(card), ids.to(card)
    norms = None if norms is None else norms.to(card)
    plain = rk.rescore_rd_reference(pts, qs, ids, block=block, norms=norms)
    launches = rk.rescore_rd.launches
    pairs = profiling.counters().get("rescore.pairs", 0)
    got = rk.rescore_rd(pts, qs, ids, block=block, norms=norms)
    torch.cuda.synchronize()
    assert rk.rescore_rd.launches == launches + 1
    assert (profiling.counters()["rescore.pairs"]
            == pairs + ids.shape[0] * ids.shape[1] * block)
    assert got.dtype == pts.dtype and got.shape == plain.shape
    assert torch.equal(torch.isinf(got), torch.isinf(plain))
    fin = torch.isfinite(plain)
    safe = torch.where(fin, _rows_of(ids, block), 0).long()
    diff = qs[:, None, :] - pts[safe]
    oracle = torch.sum(diff.double() ** 2, dim=-1)
    vec = d * pts.element_size() % 16 == 0
    tol = (rk.rescore_rounding(d, pts.dtype, vec)
           + d * torch.finfo(torch.float64).eps)
    err = torch.abs(got.double() - oracle)[fin]
    assert bool(torch.all(err <= tol * oracle[fin])), float(err.max())


def _rows_of(ids, block):
    off = torch.arange(block, dtype=torch.int64, device=ids.device)
    return (ids.long()[:, :, None] * block + off).reshape(ids.shape[0], -1)


@pytest.mark.card
def test_kernel_takes_strided_ids_and_empty_shapes(card):
    """A column slice of ids (two_phase's ``sid[:, :k]``) and an empty
    batch: the same rdist as contiguous ids; nothing launched for no
    pairs."""
    pts, norms, qs, ids = _case(128, 128, np.int64, np.float32, q=5,
                                width=5)
    pts, norms, qs, ids = (t.to(card) for t in (pts, norms, qs, ids))
    wide = torch.cat([ids, ids], dim=1)[:, :5]
    assert wide.stride(1) == 1 and wide.stride(0) == 10
    assert torch.equal(rk.rescore_rd(pts, qs, wide, block=128, norms=norms),
                       rk.rescore_rd(pts, qs, ids, block=128, norms=norms))
    launches = rk.rescore_rd.launches
    out = rk.rescore_rd(pts, qs[:0], ids[:0], block=128, norms=norms)
    assert out.shape == (0, 640) and rk.rescore_rd.launches == launches


@pytest.mark.card
def test_kernel_promotes_mixed_types(card):
    """float32 points with float64 queries (and float64 norms): the plain
    version's promoted arithmetic, float64, within its rounding bound."""
    pts, norms, qs, ids = _case(16, 100, np.int32, np.float32, q=6)
    pts, norms, ids = pts.to(card), norms.double().to(card), ids.to(card)
    qs = qs.double().to(card)
    got = rk.rescore_rd(pts, qs, ids, block=16, norms=norms)
    want = rk.rescore_rd_reference(pts, qs, ids, block=16, norms=norms)
    assert got.dtype == want.dtype == torch.float64
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    tol = (rk.rescore_rounding(100, torch.float64, True)
           + 100 * torch.finfo(torch.float64).eps)
    assert bool(torch.all(torch.abs(got - want)[fin] <= tol * want[fin]))
