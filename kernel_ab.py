"""Time two checkouts' u-domain kernels and the MST scan on one card, in
turns.

    python3 kernel_ab.py --parent <root of the other checkout>

The other checkout is, for instance, an earlier commit unpacked with
``git archive <commit> | tar -x -C build/ab/parent``.  Each side runs in a
process of its own that imports that checkout's ``petal_neighbors_tpu_torch``
and calls its wrappers as a user would (``knn_capped``, ``knn_bcap``,
``knn_merge``, ``bcap_minima``, ``subchunk_minima``, ``knn_fold_lazy``,
``scan_minout``), so the two trees may differ in their C interfaces; each
builds its kernels into its own ``build/kernels/``.  Each shape's index is
a ``BruteForce``; where a tree's tensor-core wrappers take the index's
piece planes (``point_planes``), they get them, split once as the index
holds them (``split_<kind>_<n>x<d>``: that split's time and bytes), and
each call splits its queries.  It times, with data uniform in [0, 255)
(the cosine index's centred):

* on the SIFT-1M shape of chip_smoke.py (1M x 128, 10,240 queries, seed
  7): capped at k=108 (tile 4096 rows, the route's passes), the main
  path's k=100 call, and whether the two trees give it the same sorted
  rdist and thr bits (``capped_bits_equal``; ids compared as sorted rows,
  ``capped_rows_ids_differ``, since the last row range to arrive merges
  the others in and an exact tie at the k-th value may fall either way);
  capped at k=18 (``knn_capped_k18``); bcap at kb=18 (128 blocks a tile),
  the main path's k=10 call; the block minima of bcap2 and the subchunk
  minima of two_phase; merge at k=2048 over 2,048 queries; fold_lazy at
  k_scan 18 (the opt-in fold_lazy k=10 call), and whether the two trees
  give it the same sorted rdist bits (``lazy_bits_equal``; both are
  fold's);
* capped at the route's k=10 call on the GIST shape (1M x 960, 1,000
  queries), on the GloVe shape (a cosine index of 1,183,514 x 100, 10,000
  queries), at VP config 2 (100k x 2, 4,096 queries) and at the MST's core
  pass (1M x 8, 8,192 queries, k=5).

Each tensor-core row also gives ``read_tb_s``: the bytes its product loop
reads (``_read_bytes``: the points once per 128-query block, as piece
planes or as float32 rows, and the queries) over the fastest time, in
TB/s, from L2 where the blocks at once share their rows.

On the MST workload's points (chip_smoke.py's 1M x 8,
seed 0xB0), with core distances (0.15 u)^2, u uniform (seed 1), and a
labelling of 64 components (an 8 x 8 grid over the first two features),
written once by this process and read by every side, it times the Borůvka
scan ``scan_minout`` at chip_smoke.py's reduced shape (16,384 query rows
x 1M) and at one full round (1M x 1M), and its plain version on the
host's CPU (``scan_minout`` on CPU tensors) at one of that version's
4,096 x 16,384 tiles (the first 4,096 and 16,384 rows; ``*_cpu_ms``, one
call each on the host's clock).  The two trees' float32 bits may differ
by design (a fused or a separately rounded sum), so for each side it
reports, against the first parent turn, the largest bw difference in f32
ulp and the count of bj that differ (``*_vs_parent``), and the largest
distance of its bw from the same edge's weight in float64 in ulp
(``*_vs_f64``), with the SM clock and power draw nvidia-smi read during
the full rounds (medians of 100 ms samples).

The sides run parent, change, change, parent, one process each (CUDA
events, 3 rounds of 3 launches per kernel and process).  Prints one JSON
line per kernel and the card's name and power limit.  Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROUNDS = 3


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps``, after one warm
    call."""
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


def host_ms(fn) -> float:
    """Host milliseconds of one call."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


class Sampler:
    """nvidia-smi's SM clock and power draw every 100 ms while the block
    runs; ``medians()`` gives (MHz, W) over the samples."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.lines = self.proc.communicate(timeout=60)[0].splitlines()

    def medians(self):
        vals = [[float(x) for x in line.split(",")] for line in self.lines
                if line.count(",") == 1]
        if not vals:
            return None, None
        return tuple(float(v) for v in np.median(np.array(vals), axis=0))


def _planes_of(kk, mk):
    """Whether the tree's tensor-core wrappers take the points' piece planes
    (``point_planes``), and its ``split_planes`` (None where they do
    not)."""
    import inspect

    if "point_planes" not in inspect.signature(kk.knn_capped).parameters:
        return None
    from petal_neighbors_tpu_torch.ops.cuda.tc_planes import split_planes
    return split_planes


def _read_bytes(n: int, d: int, q: int, planes: bool, hoist: bool) -> int:
    """Bytes the product loop reads from L2 or device memory in one launch:
    the points once per 128-query block, and the queries once per block
    (resident) or once per 128-row tile (streamed); as piece planes (24,576
    bytes a 128-row tile and 32-feature chunk) or as float32 rows."""
    blocks, tiles = -(-q // 128), -(-n // 128)
    if planes:
        chunk = -(-d // 32) * 24576
        return blocks * tiles * chunk + blocks * chunk * (1 if hoist
                                                          else tiles)
    return blocks * n * d * 4 + blocks * 128 * d * 4 * (1 if hoist
                                                         else tiles)


def worker(tree: str, spec: dict, out: str) -> None:
    """One side: the kernels of the checkout at ``tree`` at the shapes in
    ``spec``; writes {kernel: {"ms": [...], "plan": ..., "read_tb_s": ...}}
    to ``out`` (JSON) and capped's and fold_lazy's sorted outputs beside it
    (``.npz``).  A tree whose wrappers take the index's piece planes is
    handed them (made once, as an index holds them; ``split_ms`` times
    that split); each call splits its own queries."""
    sys.path.insert(0, tree)
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import _build
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk
    from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as msk

    if not Path(pt.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {pt.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    split = _planes_of(kk, mk)
    row, keep = {}, {}

    def timed(name, fn, plan, n, d, q, hoist):
        ms = [cuda_ms(fn, reps=3) for _ in range(ROUNDS)]
        read = _read_bytes(n, d, q, split is not None, hoist)
        row[name] = {"ms": ms, "plan": plan,
                     "read_tb_s": read / (min(ms) * 1e-3) / 1e12}

    def shape(kind, n, dim, q, seed):
        rng = np.random.default_rng(seed)
        points = rng.random((n, dim), dtype=np.float32) * 255.0
        queries = rng.random((q, dim), dtype=np.float32) * 255.0
        if kind == "cosine":
            points, queries = points - 127.5, queries - 127.5
            index = pt.BruteForce(points, "cosine")
            qc = torch.from_numpy(queries).cuda()
            qc = qc / torch.sqrt(torch.sum(qc * qc, 1, keepdim=True))
        else:
            index = pt.BruteForce.euclidean(points)
            qc = torch.from_numpy(queries).cuda() - index._center
        pp, pn = index._pts, index._norms
        kw = {}
        if split is not None:
            planes = split(pp)
            kw = {"point_planes": planes}
            row[f"split_{kind}_{n}x{dim}"] = {
                "ms": [cuda_ms(lambda: split(pp), reps=3)
                       for _ in range(ROUNDS)],
                "plan": [n, dim], "bytes": int(planes.numel() * 2)}
        del index
        return pp, pn, qc.contiguous(), kw

    def capped(name, pp, pn, qc, kw, k, tile, passes):
        n, d = pp.shape
        fn = lambda: kk.knn_capped(pp, qc, pn, k=k, tile=tile, passes=passes,
                                   **kw)
        timed(name, fn, kk.kernel_plan("capped", n, qc.shape[0], d, k, tile),
              n, d, qc.shape[0], d <= 96)
        return fn

    # SIFT: the batch cells' k=10 (bcap) and k=100 (capped k_scan 108)
    pp, pn, qc, kw = shape("euclidean", spec["n"], spec["dim"], spec["q"],
                           spec["seed"])
    n, d = pp.shape
    nq = qc.shape[0]
    bk, btile, bpasses = spec["bcap"]
    timed("knn_bcap", lambda: kk.knn_bcap(pp, qc, pn, k=bk, tile=btile,
                                          passes=bpasses, **kw),
          kk.kernel_plan("bcap", n, nq, d, bk, btile), n, d, nq, True)
    ck, ctile, cpasses = spec["capped"]
    run_capped = capped("knn_capped", pp, pn, qc, kw, ck, ctile, cpasses)
    capped("knn_capped_k18", pp, pn, qc, kw, *spec["capped18"])
    timed("bcap_minima", lambda: mk.bcap_minima(pp, qc, pn, **kw),
          mk.minima_plan("block", n, nq, d), n, d, nq, True)
    timed("subchunk_minima", lambda: mk.subchunk_minima(pp, qc, pn, **kw),
          mk.minima_plan("subchunk", n, nq, d), n, d, nq, True)
    mq, mkk = spec["merge"]
    timed("knn_merge", lambda: kk.knn_merge(pp, qc[:mq], pn, k=mkk, **kw),
          kk.kernel_plan("merge", n, mq, d, mkk), n, d, mq, False)
    lk = spec["fold_lazy"][0]
    run_lazy = lambda: kk.knn_fold_lazy(pp, qc, pn, k=lk)
    timed("knn_fold_lazy", run_lazy,
          kk.kernel_plan("fold_lazy", n, nq, d, lk), n, d, nq, True)
    rd, ids, thr = run_capped()
    lazy_rd, _ = run_lazy()
    keep.update(
        rdist=torch.sort(rd, 1).values.view(torch.int32).cpu().numpy(),
        ids=torch.sort(ids, 1).values.cpu().numpy(),
        thr=thr.view(torch.int32).cpu().numpy(),
        lazy_rdist=torch.sort(lazy_rd, 1).values.view(torch.int32)
        .cpu().numpy())
    del pp, pn, qc, kw
    torch.cuda.empty_cache()
    # GIST (capped at d = 960), the GloVe shape (cosine, capped at d = 100),
    # VP config 2 (d = 2) and the MST core pass (d = 8)
    for name, kind, n, dim, q, seed, args in spec["capped_shapes"]:
        pp, pn, qc, kw = shape(kind, n, dim, q, seed)
        capped(name, pp, pn, qc, kw, *args)
        del pp, pn, qc, kw
        torch.cuda.empty_cache()
    mst = {key: torch.from_numpy(val).cuda()
           for key, val in np.load(spec["mst"]).items()}
    full = (mst["pts"], mst["core_rd"], mst["comp"], mst["pts"],
            mst["core_rd"], mst["comp"])
    qn = spec["mst_q"]
    reduced = tuple(a[:qn] if i >= 3 else a for i, a in enumerate(full))
    row["scan_minout"] = {
        "ms": [cuda_ms(lambda: msk.scan_minout(*reduced), reps=3)
               for _ in range(ROUNDS)],
        "plan": {"q": qn, "n": int(full[0].shape[0]),
                 "d": int(full[0].shape[1])}}
    with Sampler() as smi:
        row["scan_minout"]["full_ms"] = [
            cuda_ms(lambda: msk.scan_minout(*full), reps=1)
            for _ in range(ROUNDS)]
    (row["scan_minout"]["full_sm_mhz"],
     row["scan_minout"]["full_power_w"]) = smi.medians()
    cpu = tuple(a[:spec["cpu_q"] if i >= 3 else spec["cpu_n"]].cpu()
                for i, a in enumerate(full))
    row["scan_minout"]["cpu_ms"] = [
        host_ms(lambda: msk.scan_minout(*cpu)) for _ in range(ROUNDS)]
    keep["scan_bw"], keep["scan_bj"] = (
        a.cpu().numpy() for a in msk.scan_minout(*full))
    np.savez(out + ".npz", **keep)
    Path(out).write_text(json.dumps(row))


def mst_inputs(path: str) -> None:
    """The scan's inputs, written once for every side: chip_smoke.py's MST
    points, core distances (0.15 u)^2 and an 8 x 8 grid labelling."""
    import chip_smoke as cs

    pts = np.random.default_rng(cs.MST_SEED).random((cs.MST_N, cs.MST_D),
                                                    dtype=np.float32)
    u = np.random.default_rng(1).random(cs.MST_N, dtype=np.float32)
    cells = np.minimum((pts[:, :2] * 8).astype(np.int32), 7)
    np.savez(path, pts=pts, core_rd=(u * np.float32(0.15)) ** 2,
             comp=(cells[:, 0] + 8 * cells[:, 1]).astype(np.int32))


def scan_checks(mst_path: str, first: dict, out: dict) -> dict:
    """``out``'s scan against ``first``'s (the first parent turn): the
    largest bw difference in f32 ulp and the bj that differ; and its bw
    against the float64 weight of its own (i, bj), in f32 ulp."""
    inp = np.load(mst_path)
    bw, bj, base = out["scan_bw"], out["scan_bj"], first["scan_bw"]
    fin = np.isfinite(bw) & np.isfinite(base)
    ulp = np.abs(bw[fin].astype(np.float64) - base[fin]) / np.spacing(
        base[fin]).astype(np.float64)
    pts = inp["pts"].astype(np.float64)
    core = inp["core_rd"].astype(np.float64)
    i = np.flatnonzero(bj >= 0)
    rd = ((pts[i] - pts[bj[i]]) ** 2).sum(1)
    w64 = np.maximum(np.maximum(rd, core[i]), core[bj[i]])
    return {
        "bw_max_ulp_vs_parent": float(ulp.max(initial=0.0)),
        "bw_inf_differ_vs_parent": int((np.isinf(bw) != np.isinf(base))
                                       .sum()),
        "bj_differ_vs_parent": int((bj != first["scan_bj"]).sum()),
        "bw_max_ulp_vs_f64": float(np.max(np.abs(bw[i] - w64)
                                          / np.spacing(bw[i]),
                                          initial=0.0))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--spec", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        worker(args.worker, json.loads(args.spec), args.out)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import chip_smoke as cs

    glove = (1_183_514, 100, 10_000)
    spec = {"seed": cs.SEED, "n": cs.N, "dim": cs.DIM, "q": cs.N_Q,
            "capped": cs.kernel_args("capped", 100, cs.N),
            "capped18": cs.kernel_args("capped", 10, cs.N),
            "bcap": cs.kernel_args("bcap", 10, cs.N),
            "merge": (cs.N_Q_LARGE, 2048),
            "fold_lazy": cs.kernel_args("fold_lazy", 10, cs.N),
            "capped_shapes": [
                ("knn_capped_gist", "euclidean", cs.GIST_N, cs.GIST_D,
                 cs.GIST_Q, cs.GIST_SEED,
                 cs.kernel_args("capped", 10, cs.GIST_N)),
                ("knn_capped_glove", "cosine", *glove, 3,
                 cs.kernel_args("capped", 10, glove[0])),
                ("knn_capped_vp2", "euclidean", cs.VP_N, 2, cs.VP_BATCHES[-1],
                 cs.VP_SEED, cs.kernel_args("capped", 10, cs.VP_N)),
                ("knn_capped_mst_core", "euclidean", cs.MST_N, cs.MST_D,
                 cs.MST_HOLD_Q, cs.MST_SEED,
                 cs.kernel_args("capped", cs.MST_K, cs.MST_N))],
            "mst_q": cs.MST_REDUCED_Q, "cpu_q": 4096, "cpu_n": 16384}
    trees = {"parent": str(Path(args.parent).resolve()), "change": str(ROOT)}
    runs = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spec["mst"] = os.path.join(tmp, "mst.npz")
        mst_inputs(spec["mst"])
        for turn, side in enumerate(("parent", "change", "change",
                                     "parent")):
            out = os.path.join(tmp, f"{turn}.json")
            subprocess.run([sys.executable, __file__, "--worker",
                            trees[side], "--spec", json.dumps(spec),
                            "--out", out], check=True, timeout=900)
            runs.append((side, json.loads(Path(out).read_text()),
                         dict(np.load(out + ".npz"))))
        scans = [scan_checks(spec["mst"], runs[0][2], out)
                 for _, _, out in runs]
    names = sorted({name for _, r, _ in runs for name in r})
    for name in names:
        row = {"kernel": name}
        for side in ("parent", "change"):
            mine = [r[name] for s, r, _ in runs if s == side and name in r]
            if not mine:
                continue
            row[f"{side}_ms"] = [ms for r in mine for ms in r["ms"]]
            row[f"{side}_plan"] = mine[0]["plan"]
            for key in ("read_tb_s", "bytes"):
                if key in mine[0]:
                    row[f"{side}_{key}"] = [r[key] for r in mine]
        if name == "knn_capped":
            first = runs[0][2]
            row["capped_bits_equal"] = all(
                np.array_equal(first[key], out[key])
                for _, _, out in runs for key in ("rdist", "thr"))
            row["capped_rows_ids_differ"] = max(
                int((first["ids"] != out["ids"]).any(1).sum())
                for _, _, out in runs)
        if name == "scan_minout":
            for side in ("parent", "change"):
                for key in ("full_ms", "cpu_ms"):
                    row[f"{side}_{key}"] = [
                        ms for s, r, _ in runs if s == side
                        for ms in r[name][key]]
                row[f"{side}_checks"] = [c for (s, _, _), c in zip(runs, scans)
                                         if s == side]
                row[f"{side}_sm_mhz_power_w"] = [
                    (r[name]["full_sm_mhz"], r[name]["full_power_w"])
                    for s, r, _ in runs if s == side]
        if name == "knn_fold_lazy":
            row["lazy_bits_equal"] = all(
                np.array_equal(runs[0][2]["lazy_rdist"], out["lazy_rdist"])
                for _, _, out in runs)
        print(json.dumps(row), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
