"""Drive petal_neighbors_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — compiles every kernel source under
              petal_neighbors_tpu_torch/ops/cuda/csrc with nvcc.
3. kernel   — each kernel (fold, capped, bcap, merge) against its plain
              PyTorch version on the card, with the same launch plan: small
              shapes with NaN rows, NaN queries, duplicated rows and ragged
              tails (at the vectorized and the chunked scalar widths, split
              into row ranges or not, working set in shared or global
              memory), k = 1024 (fold) and 1100 to 4096 (merge), and the
              main paths' shapes over 1M x 128.  Sorted rdist and
              thresholds must agree within the stated tolerance, and an id
              may differ only against one of near-equal rdist.  The two row
              sorts (bitonic, rank) against a stable ``torch.sort`` at the
              large-k path's widths with duplicate keys and +inf tails:
              keys equal, payloads equal (rank) or equal as multisets
              within each run of equal keys (bitonic).
4. main     — ``BruteForce.euclidean`` over 1M x 128 f32 points (seed 7,
              as bench.py makes them) answering 10,240 queries at k=10
              (bcap), k=100 and k=200 (capped); every kernel's launches in
              that run and the queries each fold repair carried; every
              query's ids against a chunked f64 oracle on the card, where
              an id may differ only by a swap that f32 direct-form
              distances cannot order.
5. main_large_k — the same index answering the first 2,048 queries at
              k=1000 (capped, re-ranked by the bitonic sort), k=2000 and
              k=3000 (merge; the bitonic and the rank sort), with the same
              oracle check and the launches of that run.
6. kernels  — one JSON line: every kernel with its launches on its main
              path, error against its plain version, its time, the plain
              version's time, its bound and a PyTorch yardstick.

Then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when no CUDA card is present or any
phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, DIM, N_Q, SEED = 1_000_000, 128, 10_240, 7
#: the main path's requests and the scheme each must take
MAIN_K = {10: "bcap", 100: "capped", 200: "capped"}
#: the large-k path (bench.py:212-221): queries, requests and schemes
N_Q_LARGE = 2048
LARGE_K = {1000: "capped", 2000: "merge", 3000: "merge"}
#: boundary swaps against the f64 oracle allowed per 10^6 returned ids
SWAPS_PER_MILLION = 5
#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
#: FP32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
KNN_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/knn_fold.cu"
SORT_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/row_sort.cu"
REPLACES = {"fold": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:186",
            "capped": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:429",
            "bcap": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:546",
            "merge": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:336",
            "bitonic_sort": "petal_neighbors_tpu/ops/pallas/sort_kernel.py:36",
            "rank_sort":
                "petal_neighbors_tpu/ops/pallas/rank_sort_kernel.py:48"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device milliseconds per call, by CUDA events over ``reps``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n: int, q: int, d: int, k: int) -> tuple[float, str]:
    """Least time for a kernel's work: each input read once and each
    output written once (working set and threshold) over the memory rate,
    against 2*Q*N*d FP32 FLOP over the SIMT peak; the larger one bounds."""
    bytes_ = 4 * (n * d + n + q * d) + 8 * q * k + 4 * q
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = 2.0 * q * n * d / PEAK_FP32_FLOP_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_topk(points, queries, norms, k: int, block: int = 1,
                 chunk: int = 65536):
    """Yardstick: the same top-k of u (of 16-row block minima of u when
    ``block`` > 1) by a chunked ``torch.matmul`` plus ``torch.topk`` and a
    merge — cuBLAS, timed here and used nowhere in the port."""
    best_u = best_i = None
    for s in range(0, points.shape[0], chunk):
        u = norms[s:s + chunk][None, :] - 2.0 * (queries @ points[s:s + chunk].T)
        if block > 1:
            u = u.reshape(u.shape[0], -1, block).amin(dim=2)
        vu, vi = torch.topk(u, min(k, u.shape[1]), dim=1, largest=False)
        vi = vi + s // block
        if best_u is None:
            best_u, best_i = vu, vi
        else:
            cu = torch.cat([best_u, vu], 1)
            ci = torch.cat([best_i, vi], 1)
            best_u, pos = torch.topk(cu, k, dim=1, largest=False)
            best_i = torch.gather(ci, 1, pos)
    return best_u, best_i


def _run(scheme: str, plain: bool, pp, qt, pn, k: int, tile: int,
         passes: int, splits: int = 1):
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    if scheme in ("fold", "merge"):
        run = {("fold", True): kk.knn_fold_reference,
               ("fold", False): kk.knn_fold,
               ("merge", True): kk.knn_merge_reference,
               ("merge", False): kk.knn_merge}[scheme, plain]
        return run(pp, qt, pn, k=k) + (None,)
    if plain:
        ref = (kk.knn_capped_reference if scheme == "capped"
               else kk.knn_bcap_reference)
        return ref(pp, qt, pn, k=k, tile=tile, passes=passes, splits=splits)
    run = kk.knn_capped if scheme == "capped" else kk.knn_bcap
    return run(pp, qt, pn, k=k, tile=tile, passes=passes)


def compare_kernel(scheme: str, pp, qt, pn, k: int, tile: int = 1,
                   passes: int = 0):
    """Kernel vs plain version on the same card tensors and the same launch
    plan.  Returns (max_abs_err over matched sorted rdist and thresholds,
    rows whose ids differ between near-equal rdist, the plan).

    Tolerance: the two sum the d-term dot product in different orders, so
    a score may differ by the f32 accumulation bound d*2^-24*(‖q‖²+‖x‖²)
    (the JAX package's _proof_err accumulation term); sorted rdist and
    thresholds must agree within twice that.  Where a row's id sets
    differ, its differing ids, paired in rdist order, must lie within that
    band of each other: near ties may fall either way, in the capped and
    bcap schemes also at a pass's `u < tau` test."""
    from petal_neighbors_tpu_torch.ops.cuda.knn_kernel import kernel_plan

    plan = kernel_plan(scheme, pp.shape[0], qt.shape[0], pp.shape[1], k,
                       tile)
    rd_k, id_k, t_k = _run(scheme, False, pp, qt, pn, k, tile, passes)
    torch.cuda.synchronize()
    if scheme == "merge" and not bool((rd_k[:, 1:] >= rd_k[:, :-1]).all()):
        raise AssertionError(f"merge k={k}: rows not ascending")
    rd_p, id_p, t_p = _run(scheme, True, pp, qt, pn, k, tile, passes,
                           plan[0])
    rd_k, ord_k = torch.sort(rd_k, dim=1)
    id_k = torch.gather(id_k, 1, ord_k)
    rd_p, ord_p = torch.sort(rd_p, dim=1)
    id_p = torch.gather(id_p, 1, ord_p)
    xn_max = torch.where(torch.isfinite(pn), pn, 0.0).max()
    qn = torch.sum(qt * qt, dim=1)
    band = 2.0 * pp.shape[1] * 2.0 ** -24 * (qn + xn_max)
    fin = torch.isfinite(rd_p)
    if not torch.equal(fin, torch.isfinite(rd_k)):
        raise AssertionError(f"{scheme} k={k}: finite slots differ")
    diff = torch.where(fin, (rd_k - rd_p).abs(), 0.0)
    if bool((diff > band[:, None]).any()):
        raise AssertionError(f"{scheme} k={k}: rdist off by "
                             f"{float(diff.max())}")
    err = float(diff.max())
    nanq = torch.isnan(qt).any(dim=1)
    if bool((id_k[nanq] != -1).any()) or bool(torch.isfinite(rd_k[nanq]).any()):
        raise AssertionError(f"{scheme}: a NaN query row picked up results")
    if t_k is not None:
        if not torch.equal(torch.isnan(t_k), nanq) or not torch.equal(
                torch.isnan(t_p), nanq):
            raise AssertionError(f"{scheme}: NaN thresholds off NaN queries")
        tf = torch.isfinite(t_p) & ~nanq
        if not torch.equal(tf, torch.isfinite(t_k) & ~nanq):
            raise AssertionError(f"{scheme}: finite thresholds differ")
        tdiff = torch.where(tf, (t_k - t_p).abs(), 0.0)
        if bool((tdiff > band).any()):
            raise AssertionError(f"{scheme} k={k}: thr off by "
                                 f"{float(tdiff.max())}")
        err = max(err, float(tdiff.max()))
    tied_rows = 0
    a, b = id_k.cpu().numpy(), id_p.cpu().numpy()
    rk, rp = rd_k.cpu().numpy(), rd_p.cpu().numpy()
    bnd = band.cpu().numpy()
    for r in np.flatnonzero((np.sort(a, 1) != np.sort(b, 1)).any(1)):
        sa, sb = set(a[r].tolist()), set(b[r].tolist())
        if sa == sb:
            continue
        only_k = sorted(rk[r][list(a[r]).index(x)] for x in sa - sb)
        only_p = sorted(rp[r][list(b[r]).index(x)] for x in sb - sa)
        if len(only_k) != len(only_p) or any(
                abs(x - y) > bnd[r] for x, y in zip(only_k, only_p)):
            raise AssertionError(f"{scheme} k={k}: row {r} ids differ "
                                 "off the tie band")
        tied_rows += 1
    return err, tied_rows, plan


def small_inputs(rng, n, q, d):
    """Uniform points and queries in [0, 255)^d with NaN rows (whole and
    partial), NaN queries and ten duplicated rows (exact ties), where the
    shape has room for them."""
    pts = (rng.random((n, d), dtype=np.float32) * 255.0).astype(np.float32)
    qs = (rng.random((q, d), dtype=np.float32) * 255.0).astype(np.float32)
    if n >= 100:
        pts[[3, 77, n - 2]] = np.nan
        pts[11, d // 2] = np.nan
        pts[20:30] = pts[20]
    if q >= 8:
        qs[[0, q - 1]] = np.nan
        qs[5, d // 2] = np.nan
    return pts, qs


#: (scheme, n, q, d, pad rows, k, tile, passes): tn=1 keeps N ragged for
#: the kernel itself; d=5, 130 and 257 run the scalar-load path (130 and
#: 257 in feature chunks); n=1 with k above n; the 70,001-row shapes split
#: the rows (working set in shared and in global memory)
SMALL_CASES = (
    ("fold", 5003, 301, 128, 1, 18, 1, 0),
    ("fold", 5003, 301, 128, 64, 108, 1, 0),
    ("fold", 4099, 130, 130, 1, 40, 1, 0),
    ("fold", 3001, 70, 257, 1, 33, 1, 0),
    ("fold", 700, 64, 5, 1, 9, 1, 0),
    ("fold", 1, 3, 8, 1, 4, 1, 0),
    ("fold", 70001, 300, 128, 1, 18, 1, 0),
    ("fold", 70001, 200, 128, 64, 1024, 1, 0),
    ("capped", 5003, 301, 128, 1, 18, 512, 2),
    ("capped", 5003, 301, 128, 64, 108, 512, 0),
    ("capped", 4099, 130, 130, 1, 40, 1024, 4),
    ("capped", 3001, 70, 257, 1, 33, 64, 15),
    ("capped", 700, 64, 5, 1, 9, 64, 1),
    ("capped", 70001, 300, 128, 1, 18, 4096, 2),
    ("capped", 70001, 200, 128, 64, 1024, 2048, 4),
    ("bcap", 5003, 301, 128, 1, 18, 32, 2),
    ("bcap", 5003, 301, 128, 64, 4, 4, 0),
    ("bcap", 4099, 130, 130, 1, 40, 64, 4),
    ("bcap", 3001, 70, 257, 1, 33, 128, 15),
    ("bcap", 700, 64, 5, 1, 9, 12, 1),
    ("bcap", 70001, 300, 128, 1, 18, 128, 2),
    ("bcap", 70001, 200, 128, 64, 256, 256, 4),
    ("merge", 1203, 301, 128, 1, 1100, 1, 0),
    ("merge", 2100, 130, 130, 1, 2048, 1, 0),
    ("merge", 4200, 70, 64, 64, 4096, 1, 0),
    ("merge", 70001, 300, 128, 1, 3000, 1, 0),
)

#: the main paths' kernel calls: (scheme, k requested, queries).  fold at
#: k=200 is the repair kernel of the main path, timed on the whole batch
MAIN_CALLS = (("bcap", 10, N_Q), ("capped", 100, N_Q), ("capped", 200, N_Q),
              ("fold", 200, N_Q), ("capped", 1000, N_Q_LARGE),
              ("merge", 2000, N_Q_LARGE), ("merge", 3000, N_Q_LARGE))
#: the row each kernel reports in the kernels line
MAIN_ROW = {"bcap": 10, "capped": 100, "fold": 200, "merge": 3000}
#: row sorts: (kind, widths checked, main width)
SORTS = (("bitonic_sort", (1008, 2048), 2048),
         ("rank_sort", (2176, 3072, 4096), 3072))


def kernel_args(scheme: str, k_req: int, n_real: int):
    """(k, tile, passes) of a scheme's kernel call, as knn_prepadded makes
    it."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    k_scan = bf.scan_width(scheme, k_req, n_real)
    if scheme == "bcap":
        k, tile = max(k_scan, 12), bf.BCAP_TILE
        return k, tile, bf.capped_passes(k, tile * 16, n_real, scheme)
    if scheme == "capped":
        return (k_scan, bf.CAPPED_TILE,
                bf.capped_passes(k_scan, bf.CAPPED_TILE, n_real, scheme))
    return k_scan, 1, 0


def phase_kernel(pp, pn, queries_c):
    """Each kernel against its plain version at every listed shape, then at
    the main paths' shapes; returns the main-shape rows by (scheme, k)."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    errs = {s: 0.0 for s in ("fold", "capped", "bcap", "merge")}
    for scheme, n, q, d, tn, k, tile, passes in SMALL_CASES:
        pts, qs = small_inputs(rng, n, q, d)
        spp, spn = bf.pad_for_pallas(torch.from_numpy(pts).to(dev), tn=tn)
        qt = torch.from_numpy(qs).to(dev)
        err, tied, plan = compare_kernel(scheme, spp, qt, spn, k, tile,
                                         passes)
        errs[scheme] = max(errs[scheme], err)
        emit("kernel", name=f"knn_{scheme}", n=n, q=q, d=d, k=k, tile=tile,
             passes=passes, max_abs_err=err, tied_rows=tied, plan=plan,
             ok=True)

    n_real = N
    rows = {}
    for scheme, k_req, q in MAIN_CALLS:
        qt = queries_c[:q]
        k, tile, passes = kernel_args(scheme, k_req, n_real)
        err, tied, plan = compare_kernel(scheme, pp, qt, pn, k, tile, passes)
        errs[scheme] = max(errs[scheme], err)
        ms = cuda_ms(lambda: _run(scheme, False, pp, qt, pn, k, tile,
                                  passes), reps=3)
        plain = cuda_ms(lambda: _run(scheme, True, pp, qt, pn, k, tile,
                                     passes, plan[0]), reps=1, warm=0)
        lib = cuda_ms(lambda: library_topk(
            pp, qt, pn, k, block=16 if scheme == "bcap" else 1), reps=2)
        bound, by = bound_ms(pp.shape[0], q, DIM, k)
        extra = {}
        if scheme == "merge":
            # the same launch at k=16: the tile product with few merges
            extra["ms_at_k16"] = cuda_ms(lambda: _run(
                scheme, False, pp, qt, pn, 16, 1, 0), reps=2)
        row = dict(k_request=k_req, k=k, tile=tile, passes=passes,
                   n=pp.shape[0], q=q, d=DIM,
                   peak="FP32 non-tensor 67 TFLOP/s and HBM 3.35 TB/s, H100 "
                        "SXM data sheet",
                   plan=plan, max_abs_err=err, tied_rows=tied, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bound,
                   bound_by=by, **extra)
        emit("kernel", name=f"knn_{scheme}", **row, ok=True)
        rows[scheme, k_req] = row
    return rows, errs


def sort_rows(rows: int, width: int, gen) -> tuple:
    """Rows of keys with many duplicates and a +inf tail, and distinct
    payloads, on the card."""
    keys = (torch.randint(0, max(2, width // 3), (rows, width), generator=gen)
            .float() * 0.25 + 100.0)
    keys[:, width - width // 7:] = float("inf")
    keys[: rows // 4, ::5] = float("inf")
    vals = torch.randperm(rows * width, generator=gen).int().reshape(
        rows, width)
    return keys.cuda(), vals.cuda()


def phase_sorts():
    """The bitonic and the rank sort against a stable torch.sort on the
    card: keys equal; payloads equal (rank: ties by position, as the
    contract says) or equal as multisets within each run of equal keys
    (bitonic: the contract leaves tie order free).  Then the time at the
    large-k path's shapes (2,048 rows).  Returns rows by kind."""
    from petal_neighbors_tpu_torch.ops.cuda import rank_sort_kernel as rk
    from petal_neighbors_tpu_torch.ops.cuda import sort_kernel as sk

    fns = {"bitonic_sort": (sk.bitonic_sort_pairs,
                            sk.bitonic_sort_pairs_reference),
           "rank_sort": (rk.rank_sort_pairs, rk.rank_sort_pairs_reference)}
    gen = torch.Generator().manual_seed(3)
    out = {}
    for kind, widths, main_width in SORTS:
        fn, plain = fns[kind]
        for width in widths:
            for nrows in (301, N_Q_LARGE):
                keys, vals = sort_rows(nrows, width, gen)
                ok_, ov = fn(keys, vals)
                torch.cuda.synchronize()
                rk_, rv = plain(keys, vals)
                if not torch.equal(ok_, rk_):
                    raise AssertionError(f"{kind} width {width}: keys differ")
                exact = torch.equal(ov, rv)
                if kind == "rank_sort" and not exact:
                    raise AssertionError(f"{kind} width {width}: payloads "
                                         "differ from a stable sort")
                if not exact:
                    # multisets within each run of equal keys
                    run = torch.cumsum(torch.cat([torch.ones_like(
                        ok_[:, :1], dtype=torch.long), (ok_[:, 1:] != ok_[
                            :, :-1]).long()], 1), 1)
                    key = run * (2 ** 32) + ov.long()
                    ref = run * (2 ** 32) + rv.long()
                    if not torch.equal(torch.sort(key, 1).values,
                                       torch.sort(ref, 1).values):
                        raise AssertionError(f"{kind} width {width}: "
                                             "payloads left their tie run")
            ms = cuda_ms(lambda: fn(keys, vals), reps=10)
            plain_ms = cuda_ms(lambda: plain(keys, vals), reps=10)

            def library():
                sk_, pos = torch.sort(keys, dim=1, stable=True)
                return sk_, torch.gather(vals, 1, pos)
            lib = cuda_ms(library, reps=10)
            # each key and payload read once and written once
            bound = 2 * keys.numel() * 8 / PEAK_BYTES_S * 1e3
            row = dict(rows=N_Q_LARGE, width=width, payload_exact=exact,
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=lib, bound_ms=bound, bound_by="bytes",
                       peak="HBM 3.35 TB/s, H100 SXM data sheet")
            emit("kernel", name=kind, **row, ok=True)
            if width == main_width:
                out[kind] = row
    return out


def f64_oracle(points_dev, queries_dev, k: int, chunk: int = 32768):
    """Exact f64 top-k ids, chunked over points (a check on the card, not
    the port)."""
    q64 = queries_dev.double()
    qn = (q64 * q64).sum(1, keepdim=True)
    best_d = best_i = None
    for s in range(0, points_dev.shape[0], chunk):
        p64 = points_dev[s:s + chunk].double()
        dd = qn + (p64 * p64).sum(1)[None, :] - 2.0 * (q64 @ p64.T)
        vd, vi = torch.topk(dd, k, dim=1, largest=False)
        vi = vi + s
        if best_d is None:
            best_d, best_i = vd, vi
        else:
            cd = torch.cat([best_d, vd], 1)
            ci = torch.cat([best_i, vi], 1)
            best_d, pos = torch.topk(cd, k, dim=1, largest=False)
            best_i = torch.gather(ci, 1, pos)
    return best_d.clamp_min(0).sqrt(), best_i


def check_vs_oracle(index, points_dev, queries_dev, ids, oracle_ids):
    """Every query's ids against the f64 oracle's.

    The port is exact to f32 direct-form distances (the JAX package's
    contract), so an id may differ from the oracle's only by a swap that
    those distances cannot order: each of the port's extra ids must be no
    farther, in the f32 direct form over the index's centered copy (as
    ``rescore_exact`` computes it, up to 2^-22 relative for the summation
    order), than every oracle id it displaced.
    Swaps are capped at SWAPS_PER_MILLION per 10^6 returned ids.  Returns
    (recall, swaps, the largest f64 gap of a swap over the f32 rounding
    band 4*d*2^-24*rd)."""
    from petal_neighbors_tpu_torch.ops.topk import rescore_exact

    a = torch.sort(ids.long(), dim=1).values.cpu().tolist()
    b = torch.sort(oracle_ids, dim=1).values.cpu().tolist()
    qc = queries_dev - index._center
    hits, swaps, worst = 0, 0, 0.0
    for r, (x, y) in enumerate(zip(a, b)):
        sx, sy = set(x), set(y)
        hits += len(sx & sy)
        if sx == sy:
            continue
        got, missed = sorted(sx - sy), sorted(sy - sx)
        cand = torch.tensor([got + missed], dtype=torch.int32,
                            device=ids.device)
        rd32, order = rescore_exact(index._pts, qc[r:r + 1], cand,
                                    cand.shape[1])
        rd_of = dict(zip(order[0].tolist(), rd32[0].tolist()))
        # 2^-22 relative: the few ulps by which another summation order
        # of the same d terms may round
        if max(rd_of[p] for p in got) > min(
                rd_of[o] for o in missed) * (1.0 + 2.0 ** -22):
            raise AssertionError(f"query {r}: the port returned an id "
                                 "farther in f32 than an oracle id it left")
        q64 = queries_dev[r].double()

        def rd64(pid):
            return float(((points_dev[pid].double() - q64) ** 2).sum())
        gap = max(rd64(p) for p in got) - min(rd64(o) for o in missed)
        band = 4.0 * points_dev.shape[1] * 2.0 ** -24 * min(
            rd64(o) for o in missed)
        swaps += len(got)
        worst = max(worst, gap / band)
    n_ids = len(a) * len(a[0])
    if swaps > max(1, SWAPS_PER_MILLION * n_ids // 10 ** 6):
        raise AssertionError(f"{swaps} boundary swaps in {n_ids} ids")
    return hits / n_ids, swaps, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import _build
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    smi = smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         dir=os.path.relpath(_build.build_dir(),
                             os.path.dirname(os.path.abspath(__file__))))
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)

    rng = np.random.default_rng(SEED)
    points = rng.random((N, DIM), dtype=np.float32) * 255.0
    queries = rng.random((N_Q, DIM), dtype=np.float32) * 255.0

    t0 = time.perf_counter()
    index = pt.BruteForce.euclidean(points)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qdev = torch.from_numpy(queries).cuda()

    # ---- kernel vs plain (launches here are not the main paths') -------
    rows, errs = phase_kernel(index._pts, index._norms, qdev - index._center)
    sorts = phase_sorts()

    # ---- the main paths ------------------------------------------------
    from petal_neighbors_tpu_torch.ops.cuda import rank_sort_kernel as rk
    from petal_neighbors_tpu_torch.ops.cuda import sort_kernel as sk

    wrappers = {"fold": kk.knn_fold, "capped": kk.knn_capped,
                "bcap": kk.knn_bcap, "merge": kk.knn_merge,
                "bitonic_sort": sk.bitonic_sort_pairs,
                "rank_sort": rk.rank_sort_pairs}
    # the route's fold calls, with their query counts: under bcap and
    # capped they are the repairs of the queries the proof left uncovered
    fold_rows = []

    def counted_fold(points, queries, norms, *, k):
        fold_rows.append(queries.shape[0])
        return kk.knn_fold(points, queries, norms, k=k)

    bf.knn_fold = counted_fold
    pdev = torch.from_numpy(points).cuda()
    launches = {}
    for phase, ks, qs, reps, need in (
            ("main", MAIN_K, qdev, 3, ("fold", "capped", "bcap")),
            ("main_large_k", LARGE_K, qdev[:N_Q_LARGE], 2,
             ("capped", "merge", "bitonic_sort", "rank_sort"))):
        for w in wrappers.values():
            w.launches = 0
        out, per_k, repaired = {}, {}, {}
        for k, scheme in ks.items():
            before = {s: w.launches for s, w in wrappers.items()}
            fold_rows.clear()
            d, i = index.query_batch(qs, k)          # warm
            torch.cuda.synchronize()
            if (index.last_backend, index.last_scheme) != ("kernel", scheme):
                raise AssertionError(f"k={k} served by {index.last_backend} "
                                     f"{index.last_scheme}, not {scheme}")
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                d, i = index.query_batch(qs, k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[k] = (d, i, min(walls))
            per_k[k] = {s: w.launches - before[s]
                        for s, w in wrappers.items()}
            repaired[k] = list(fold_rows) if scheme != "fold" else []
        got = {s: w.launches for s, w in wrappers.items()}
        for s in need:
            if got[s] == 0:
                raise AssertionError(f"{phase} launched no {s} kernel")
            # a kernel's count comes from the path of its kernels-line row
            launches.setdefault(s, got[s])

        _, oi = f64_oracle(pdev, qs, max(ks))
        for k, scheme in ks.items():
            d, i, wall = out[k]
            if d.shape != (qs.shape[0], k) or not bool(torch.isfinite(d).all()):
                raise AssertionError(f"k={k}: bad output {tuple(d.shape)}")
            if not bool((d[:, 1:] >= d[:, :-1]).all()):
                raise AssertionError(f"k={k}: distances not ascending")
            recall, swaps, worst = check_vs_oracle(index, pdev, qs, i,
                                                   oi[:, :k])
            kernel_ms = {f"knn_{s}": rows[s, k_req]["ms"]
                         for s, k_req in rows if k_req == k}
            extra = {}
            if phase == "main_large_k":
                kernel_ms.update({kind: row["ms"] for kind, row in
                                  sorts.items()})
            if phase == "main_large_k" and repaired[k]:
                # the repair's kernel on the repaired count of queries,
                # beside merge on the same work
                qr = (qs - index._center)[:repaired[k][-1]]
                k_scan = bf.scan_width(scheme, k, N)
                extra = {f"repair_{name}_ms": cuda_ms(
                    lambda: run(index._pts, qr, index._norms, k=k_scan),
                    reps=2) for name, run in (("fold", kk.knn_fold),
                                              ("merge", kk.knn_merge))}
            emit(phase, k=k, scheme=scheme, queries=qs.shape[0],
                 qps=qs.shape[0] / wall, batch_s=wall, kernel_ms=kernel_ms,
                 launches_in_calls={s: c for s, c in per_k[k].items() if c},
                 calls=reps + 1, repaired_queries_per_call=repaired[k],
                 recall=recall, oracle_queries=qs.shape[0],
                 boundary_swaps=swaps, worst_swap_gap_over_band=worst,
                 backend=index.last_backend, build_s=build_s, **extra)
        emit(phase, launches=got)

    kernels = []
    for scheme, k_req in MAIN_ROW.items():
        row = rows[scheme, k_req]
        kernels.append({
            "name": f"knn_{scheme}", "route": "cuda", "source": KNN_SOURCE,
            "replaces": REPLACES[scheme], "launches": launches[scheme],
            "max_abs_err": errs[scheme], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {key: row[key] for key in
                      ("n", "q", "d", "k", "tile", "passes", "plan")}})
    for kind, row in sorts.items():
        kernels.append({
            "name": kind, "route": "cuda", "source": SORT_SOURCE,
            "replaces": REPLACES[kind], "launches": launches[kind],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {"rows": row["rows"], "width": row["width"]}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
