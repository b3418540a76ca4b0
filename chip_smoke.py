"""Drive petal_neighbors_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — compiles every kernel source under
              petal_neighbors_tpu_torch/ops/cuda/csrc with nvcc.
3. kernel   — each kernel (fold, capped, bcap) against its plain PyTorch
              version on the card, with the same launch plan: small shapes
              with NaN rows, NaN queries, duplicated rows and ragged tails
              (at the vectorized and the chunked scalar widths, split into
              row ranges or not, working set in shared or global memory),
              k = 1024, and the main path's shapes over 1M x 128.  Sorted
              rdist and thresholds must agree within the stated tolerance,
              and an id may differ only against one of near-equal rdist.
4. main     — ``BruteForce.euclidean`` over 1M x 128 f32 points (seed 7,
              as bench.py makes them) answering 10,240 queries at k=10
              (bcap), k=100 (capped) and k=200 (fold); every kernel's
              launches in that run and the queries each fold repair
              carried; every query's ids against a chunked
              f64 oracle on the card, where an id may differ only by a
              swap that f32 direct-form distances cannot order.
5. kernels  — one JSON line: every kernel with its launches on the main
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
MAIN_K = {10: "bcap", 100: "capped", 200: "fold"}
#: boundary swaps against the f64 oracle allowed per 10^6 returned ids
SWAPS_PER_MILLION = 5
#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
#: FP32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/knn_fold.cu"
REPLACES = {"fold": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:186",
            "capped": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:429",
            "bcap": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:546"}


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

    if scheme == "fold":
        if plain:
            return kk.knn_fold_reference(pp, qt, pn, k=k) + (None,)
        return kk.knn_fold(pp, qt, pn, k=k) + (None,)
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
)


def phase_kernel(pp, pn, queries_c):
    """Each kernel against its plain version at every listed shape, then at
    the main path's shapes; returns the main-shape rows per kernel."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    errs = {s: 0.0 for s in REPLACES}
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

    # the main path's kernel calls, as knn_prepadded makes them
    n_real, q = N, queries_c.shape[0]
    main = {}
    for k_req, scheme in MAIN_K.items():
        k_scan = k_req + bf.RESCORE_SLACK
        if scheme == "bcap":
            k, tile = max(k_scan, 12), bf.BCAP_TILE
            passes = bf.capped_passes(k, tile * 16, n_real, scheme)
        elif scheme == "capped":
            k, tile = k_scan, bf.CAPPED_TILE
            passes = bf.capped_passes(k, tile, n_real, scheme)
        else:
            k, tile, passes = k_scan, 1, 0
        err, tied, plan = compare_kernel(scheme, pp, queries_c, pn, k, tile,
                                         passes)
        errs[scheme] = max(errs[scheme], err)
        ms = cuda_ms(lambda: _run(scheme, False, pp, queries_c, pn, k, tile,
                                  passes), reps=5)
        plain = cuda_ms(lambda: _run(scheme, True, pp, queries_c, pn, k,
                                     tile, passes, plan[0]), reps=1, warm=0)
        lib = cuda_ms(lambda: library_topk(
            pp, queries_c, pn, k, block=16 if scheme == "bcap" else 1),
            reps=2)
        bound, by = bound_ms(pp.shape[0], q, DIM, k)
        # the fold kernel on the same work, for a comparison in one call
        fold_same_k = (cuda_ms(lambda: _run("fold", False, pp, queries_c, pn,
                                            k_scan, 1, 0), reps=3)
                       if scheme != "fold" else ms)
        row = dict(k=k, tile=tile, passes=passes, n=pp.shape[0], q=q, d=DIM,
                   peak="FP32 non-tensor 67 TFLOP/s and HBM 3.35 TB/s, H100 "
                        "SXM data sheet",
                   plan=plan, max_abs_err=err, tied_rows=tied, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bound,
                   bound_by=by, fold_ms_at_k_scan=fold_same_k)
        emit("kernel", name=f"knn_{scheme}", **row, ok=True)
        main[scheme] = row
    return main, errs


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

    # ---- kernel vs plain (launches here are not the main path's) -------
    rows, errs = phase_kernel(index._pts, index._norms, qdev - index._center)

    # ---- main path -----------------------------------------------------
    wrappers = {"fold": kk.knn_fold, "capped": kk.knn_capped,
                "bcap": kk.knn_bcap}
    # the route's fold calls, with their query counts: at k=10 and k=100
    # they are the repairs of the queries the proof left uncovered
    fold_rows = []

    def counted_fold(points, queries, norms, *, k):
        fold_rows.append(queries.shape[0])
        return kk.knn_fold(points, queries, norms, k=k)

    bf.knn_fold = counted_fold
    for w in wrappers.values():
        w.launches = 0
    out, per_k, repaired = {}, {}, {}
    for k, scheme in MAIN_K.items():
        before = {s: w.launches for s, w in wrappers.items()}
        fold_rows.clear()
        d, i = index.query_batch(qdev, k)          # warm
        torch.cuda.synchronize()
        if (index.last_backend, index.last_scheme) != ("kernel", scheme):
            raise AssertionError(f"k={k} served by {index.last_backend} "
                                 f"{index.last_scheme}, not {scheme}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            d, i = index.query_batch(qdev, k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[k] = (d, i, min(walls))
        per_k[k] = {s: w.launches - before[s] for s, w in wrappers.items()}
        repaired[k] = list(fold_rows) if scheme != "fold" else []
    launches = {s: w.launches for s, w in wrappers.items()}
    for s, c in launches.items():
        if c == 0:
            raise AssertionError(f"the main path launched no knn_{s} kernel")

    pdev = torch.from_numpy(points).cuda()
    _, oi = f64_oracle(pdev, qdev, max(MAIN_K))
    for k, scheme in MAIN_K.items():
        d, i, wall = out[k]
        if d.shape != (N_Q, k) or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"k={k}: bad output {tuple(d.shape)}")
        if not bool((d[:, 1:] >= d[:, :-1]).all()):
            raise AssertionError(f"k={k}: distances not ascending")
        recall, swaps, worst = check_vs_oracle(index, pdev, qdev, i,
                                               oi[:, :k])
        row = rows[scheme]
        emit("main", k=k, scheme=scheme, qps=N_Q / wall, batch_s=wall,
             kernel_ms=row["ms"], bound_ms=row["bound_ms"],
             library_ms=row["library_ms"], launches_in_4_calls=per_k[k],
             repaired_queries_per_call=repaired[k],
             recall=recall, oracle_queries=N_Q, boundary_swaps=swaps,
             worst_swap_gap_over_band=worst, backend=index.last_backend,
             build_s=build_s)
    emit("main", launches=launches)

    kernels = []
    for scheme, row in rows.items():
        kernels.append({
            "name": f"knn_{scheme}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[scheme], "launches": launches[scheme],
            "max_abs_err": errs[scheme], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {key: row[key] for key in
                      ("n", "q", "d", "k", "tile", "passes", "plan")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
