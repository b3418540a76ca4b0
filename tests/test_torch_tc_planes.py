"""The tensor-core core's piece planes (``ops.cuda.tc_planes``): the plain
``split_planes`` against ``split_bf16x3`` and against the swizzled byte
layout that ``csrc/knn_tc.cuh`` reads, the planes an index holds, the
wrappers' check of the planes they are handed, and the counter
``knn.planes_split``.

The tests marked ``card`` run the kernel on a card and skip without one:
``python -m pytest --noconftest -m card tests/test_torch_tc_planes.py``
on a machine with a card (``--noconftest``: the suite's conftest imports
JAX, which that machine lacks; this file does not import it).  They hold
``csrc/split_planes.cu`` to its plain version byte for byte and the
capped and bcap kernels, on planes, to their plain versions on
``_u_tc``: sorted rdist and thr within twice the tier's proof bound
(``tc_proof_err``), ids equal but for near ties within that band, as
chip_smoke.py's ``compare_kernel`` holds them."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu_torch as pt
from petal_neighbors_tpu_torch.ops import bruteforce as bf
from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk
from petal_neighbors_tpu_torch.ops.cuda import tc_planes as tp
from petal_neighbors_tpu_torch.trees import bruteforce as tbf
from petal_neighbors_tpu_torch.utils import profiling


def _data(rows, d, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((rows, d))
                             * np.exp(rng.uniform(-8, 8, (rows, d))))
                            .astype(np.float32))


def _bytes_model(x):
    """The planes' bytes built one (row, 8-feature segment) at a time from
    the byte offsets the core reads: tile t, chunk c at (t·chunks + c) ·
    24,576, piece p at + p · 8,192, row r's segment j at (r >> 3)·512 +
    (r & 7)·64 + ((j ^ ((r >> 1) & 3)) << 4), each 16 bytes of 8
    little-endian bf16 pieces, zero past the rows and past d."""
    rows, d = x.shape
    tiles, chunks = -(-rows // 128), -(-d // 32)
    out = np.zeros(tiles * chunks * 24576, np.uint8)
    pieces = [p.to(torch.bfloat16).view(torch.int16).numpy()
              for p in kk.split_bf16x3(x)]
    for r in range(rows):
        t, rr = divmod(r, 128)
        for f0 in range(0, d, 8):
            c, j = divmod(f0 // 8, 4)
            off = ((rr >> 3) * 512 + (rr & 7) * 64
                   + ((j ^ ((rr >> 1) & 3)) << 4))
            for p in range(3):
                seg = np.zeros(8, np.int16)
                seg[:min(8, d - f0)] = pieces[p][r, f0:f0 + 8]
                at = (t * chunks + c) * 24576 + p * 8192 + off
                out[at:at + 16] = seg.view(np.uint8)
    return out


@pytest.mark.parametrize("rows,d", [(1, 2), (130, 2), (200, 8), (129, 100),
                                    (300, 128), (77, 960)])
def test_reference_bytes_at_the_core_offsets(rows, d):
    """Every byte of ``split_planes_reference`` where the core's byte
    offsets put it (``_bytes_model``), zeros past the rows and past d, at
    widths 2 to 960 and row counts that are not multiples of 128."""
    x = _data(rows, d, rows + d)
    planes = tp.split_planes_reference(x)
    assert planes.dtype == torch.bfloat16
    assert tuple(planes.shape) == tp.planes_shape(rows, d)
    got = planes.view(torch.int16).numpy().reshape(-1).view(np.uint8)
    assert np.array_equal(got, _bytes_model(x))


@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, -50), (-20, 20),
                                           (50, 100)])
def test_reference_pieces_are_the_split(lo_exp, hi_exp):
    """Unswizzled, the planes hold ``split_bf16x3``'s pieces bit for bit,
    and hi + mid + lo == x for normal float32 of both signs."""
    rng = np.random.default_rng(lo_exp + 500)
    rows, d = 260, 96
    x = torch.from_numpy((rng.choice([-1.0, 1.0], (rows, d))
                          * np.ldexp(rng.uniform(1, 2, (rows, d)),
                                     rng.integers(lo_exp, hi_exp + 1,
                                                  (rows, d))))
                         .astype(np.float32))
    planes = tp.split_planes_reference(x).float()
    tiles, chunks = planes.shape[:2]
    r = torch.arange(128)
    seg = torch.arange(4)
    # the column segment that holds feature segment j of row r
    col = (seg[None, :] ^ ((r[:, None] >> 1) & 3))
    idx = col[None, None, None, :, :, None].expand(tiles, chunks, 3, 128, 4,
                                                   8)
    flat = torch.gather(planes.reshape(tiles, chunks, 3, 128, 4, 8), 4, idx)
    pieces = flat.permute(2, 0, 3, 1, 4, 5).reshape(3, tiles * 128,
                                                    chunks * 32)
    for got, want in zip(pieces, kk.split_bf16x3(x)):
        assert torch.equal(got[:rows, :d], want)
    assert torch.equal((pieces[0] + pieces[1] + pieces[2])[:rows, :d], x)


def test_nan_rows_stay_as_padded():
    """The rows ``pad_for_pallas`` zeroed for a NaN are zero in the planes,
    as are its padding rows."""
    x = _data(150, 40, 3)
    x[[0, 77, 149], 5] = float("nan")
    pp, _ = bf.pad_for_pallas(x)
    planes = tp.split_planes_reference(pp).view(torch.int16)
    model = torch.from_numpy(_bytes_model(pp).view(np.int16).reshape(
        planes.shape))
    assert torch.equal(planes, model)
    zero = torch.zeros(pp.shape, dtype=torch.bool)
    zero[[0, 77, 149]] = True
    zero[150:] = True
    assert torch.equal(tp.split_planes_reference(torch.where(
        zero, 0.0, pp)).view(torch.int16), planes)


def test_split_counts_rows():
    """``split_planes`` adds its rows to ``knn.planes_split``."""
    before = profiling.counters().get("knn.planes_split", 0)
    tp.split_planes(_data(333, 17, 1))
    assert profiling.counters()["knn.planes_split"] - before == 333


@pytest.fixture
def planes_everywhere(monkeypatch):
    """Indexes built as on the card: ``index_planes`` splits CPU rows too
    (with the plain version, whose bytes the card's kernel writes:
    ``test_card_split_equals_plain``)."""
    monkeypatch.setattr(tbf, "index_planes", tp.split_planes)


def test_cpu_index_holds_no_planes():
    """On the CPU no index splits its rows: the flat index, its
    ``_from_prepared`` copy and the VP tree's kernel tables hold no planes,
    and building them adds nothing to ``knn.planes_split``."""
    x = _data(4100, 40, 9).numpy()
    before = profiling.counters().get("knn.planes_split", 0)
    idx = pt.BruteForce(x, device="cpu")
    again = pt.BruteForce._from_prepared(
        x, idx._pts, idx._invalid, metric="euclidean", center=idx._center,
        pnorm=idx._norms, device="cpu")
    vp = pt.VantagePointTree(x, device="cpu")
    assert idx._planes is None and again._planes is None
    assert vp._kernel_tables()[3] is None
    assert profiling.counters().get("knn.planes_split", 0) == before


@pytest.mark.parametrize("metric,d", [("euclidean", 40), ("cosine", 48)])
def test_index_holds_its_planes(metric, d, planes_everywhere):
    """A Euclidean or cosine kernel layout holds the planes of its padded
    rows, made at build and again by ``_from_prepared``; an Lp layout
    holds none."""
    x = _data(4100, d, 9).numpy()
    idx = pt.BruteForce(x, metric, device="cpu")
    assert torch.equal(idx._planes.view(torch.int16),
                       tp.split_planes_reference(idx._pts).view(torch.int16))
    again = pt.BruteForce._from_prepared(
        x, idx._pts, idx._invalid, metric=metric, center=idx._center,
        pnorm=idx._norms, device="cpu")
    assert torch.equal(again._planes.view(torch.int16),
                       idx._planes.view(torch.int16))
    assert pt.BruteForce(x, "manhattan", device="cpu")._planes is None


def test_saved_index_keeps_no_planes(tmp_path, planes_everywhere):
    """``save_index`` writes no planes; ``load_index`` makes them again and
    answers as the saved index."""
    x = _data(5000, 64, 4).numpy() * 1e-3
    q = _data(20, 64, 5).numpy() * 1e-3
    idx = pt.BruteForce(x, device="cpu")
    path = tmp_path / "flat.npz"
    pt.save_index(idx, path)
    assert not any("plane" in name for name in np.load(path).files)
    back = pt.load_index(path, device="cpu")
    assert torch.equal(back._planes.view(torch.int16),
                       idx._planes.view(torch.int16))
    d0, i0 = idx.query_batch(q, 7)
    d1, i1 = back.query_batch(q, 7)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


@pytest.mark.parametrize("call", ["capped", "bcap", "merge", "bcap_minima",
                                  "subchunk_minima"])
def test_wrappers_check_the_planes(call):
    """The tensor-core wrappers take the points' planes and refuse planes
    of another shape or type."""
    p = _data(256, 24, 6)
    q = _data(5, 24, 7)
    xn = torch.sum(p * p, dim=1)
    run = {"capped": lambda **kw: kk.knn_capped(p, q, xn, k=4, tile=128,
                                                 passes=2, **kw),
           "bcap": lambda **kw: kk.knn_bcap(p, q, xn, k=4, tile=8, passes=2,
                                             **kw),
           "merge": lambda **kw: kk.knn_merge(p, q, xn, k=4, **kw),
           "bcap_minima": lambda **kw: mk.bcap_minima(p, q, xn, **kw),
           "subchunk_minima": lambda **kw: mk.subchunk_minima(p, q, xn, **kw),
           }[call]
    want = run()
    got = run(point_planes=tp.split_planes(p))
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split_planes"):
        run(point_planes=tp.split_planes(p[:128]))
    with pytest.raises(ValueError, match="split_planes"):
        run(point_planes=tp.split_planes(p).float())


def test_route_hands_the_index_planes_down(monkeypatch, planes_everywhere):
    """``BruteForce.query_batch`` hands its planes to the capped kernel
    (the same tensor, not a new split)."""
    x = np.random.default_rng(8).uniform(0, 1, (20_000, 40)).astype(
        np.float32)
    idx = pt.BruteForce(x, device="cpu")
    seen = []
    real = kk.knn_capped

    def spy(*a, **kw):
        seen.append(kw.get("point_planes"))
        return real(*a, **kw)

    monkeypatch.setattr(bf, "knn_capped", spy)
    idx.query_batch(x[:9], 10)
    assert idx.last_scheme == "capped"
    assert len(seen) == 1 and seen[0] is idx._planes


# ---- on a card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("rows,d", [(1, 2), (130, 2), (1000, 8),
                                    (1283, 100), (4097, 128), (300, 960),
                                    (129, 33)])
def test_card_split_equals_plain(card, rows, d):
    """``csrc/split_planes.cu`` writes the plain version's bytes."""
    x = _data(rows, d, rows * d)
    got = tp.split_planes(x.to(card)).cpu().view(torch.int16)
    assert torch.equal(got, tp.split_planes_reference(x).view(torch.int16))
    # an unaligned source (the scalar loads) gives the same bytes
    wide = torch.zeros((rows, d + 1), dtype=torch.float32, device=card)
    wide[:, 1:] = x.to(card)
    odd = tp.split_planes(wide[:, 1:]).cpu().view(torch.int16)
    assert torch.equal(odd, got)


def _held(kernel, plain, q, pn, d):
    """rdist sorted per row, and thr, within twice the tier's bound
    (``tc_proof_err``: each side lies within it of the exact score); where
    a row's ids differ, the differing ids, paired in rdist order, within
    that band of each other (near ties may fall either way)."""
    xn_max = float(pn[torch.isfinite(pn)].max())
    band = 2.0 * kk.tc_proof_err(d, torch.sum(q * q, 1).double(), xn_max)
    rk, ok = torch.sort(kernel[0].cpu().double(), 1)
    rp, op = torch.sort(plain[0].double(), 1)
    ik = torch.gather(kernel[1].cpu(), 1, ok)
    ip = torch.gather(plain[1], 1, op)
    fin = torch.isfinite(rp)
    assert torch.equal(torch.isfinite(rk), fin)
    assert bool(((rk - rp).abs()[fin] <= band[:, None].expand_as(rk)[fin])
                .all())
    tk, tq = kernel[2].cpu().double(), plain[2].double()
    assert bool(((tk - tq).abs() <= band).all())
    for r in range(rk.shape[0]):
        sa, sb = set(ik[r].tolist()), set(ip[r].tolist())
        only_k = sorted(float(rk[r][ik[r].tolist().index(x)])
                        for x in sa - sb)
        only_p = sorted(float(rp[r][ip[r].tolist().index(x)])
                        for x in sb - sa)
        assert len(only_k) == len(only_p)
        assert all(abs(x - y) <= float(band[r])
                   for x, y in zip(only_k, only_p))


@pytest.mark.card
@pytest.mark.parametrize("d,k,passes", [(128, 18, 2), (128, 108, 4),
                                        (960, 18, 2), (100, 18, 2),
                                        (8, 13, 2)])
def test_card_capped_and_bcap_on_planes(card, d, k, passes):
    """capped and bcap on the card, on the index's planes, against their
    plain versions on ``_u_tc`` with the kernel's launch plan."""
    rng = np.random.default_rng(d + k)
    n, nq = 9000, 300
    p = torch.from_numpy(rng.uniform(0, 1, (n, d)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(0, 1, (nq, d)).astype(np.float32))
    pp, pn = bf.pad_for_pallas(p - bf.center_of(p))
    q = q - bf.center_of(p)
    planes = tp.split_planes(pp.to(card))
    args = (pp.to(card), q.to(card), pn.to(card))
    tile = 2048
    got = kk.knn_capped(*args, k=k, tile=tile, passes=passes,
                        point_planes=planes)
    splits = kk.kernel_plan("capped", pp.shape[0], nq, d, k, tile)[0]
    want = kk.knn_capped_reference(pp, q, pn, k=k, tile=tile, passes=passes,
                                   splits=splits)
    _held(got, want, q, pn, d)
    if k <= 32:
        got = kk.knn_bcap(*args, k=k, tile=128, passes=passes,
                          point_planes=planes)
        splits = kk.kernel_plan("bcap", pp.shape[0], nq, d, k, 128)[0]
        want = kk.knn_bcap_reference(pp, q, pn, k=k, tile=128, passes=passes,
                                     splits=splits)
        _held(got, want, q, pn, d)


@pytest.mark.card
def test_card_query_batch_splits_only_its_queries(card):
    """Once the index is built, a ``query_batch`` on the tile kernels adds
    exactly its query rows to ``knn.planes_split``."""
    x = _data(20_000, 128, 11).numpy() * 1e-2
    q = _data(300, 128, 12).numpy() * 1e-2
    idx = pt.BruteForce(x, device="cuda")
    kk.tc_probe(card)
    before = profiling.counters().get("knn.planes_split", 0)
    idx.query_batch(q, 10)
    assert idx.last_scheme in ("bcap", "capped")
    assert profiling.counters()["knn.planes_split"] - before == 300


@pytest.mark.card
def test_card_saved_index_answers_the_same(card, tmp_path):
    """A ``save_index`` / ``load_index`` round trip on the card gives the
    same answers."""
    x = _data(20_000, 128, 13).numpy() * 1e-2
    q = _data(300, 128, 14).numpy() * 1e-2
    idx = pt.BruteForce(x, device="cuda")
    pt.save_index(idx, tmp_path / "flat.npz")
    back = pt.load_index(tmp_path / "flat.npz", device="cuda")
    d0, i0 = idx.query_batch(q, 10)
    d1, i1 = back.query_batch(q, 10)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
