"""Time two checkouts' u-domain kernels and the MST scan on one card, in
turns.

    python3 kernel_ab.py --parent <root of the other checkout>

The other checkout is, for instance, an earlier commit unpacked with
``git archive <commit> | tar -x -C build/ab/parent``.  Each side runs in a
process of its own that imports that checkout's ``petal_neighbors_tpu_torch``
and calls its wrappers as a user would (``knn_capped``, ``knn_bcap``,
``bcap_minima``, ``subchunk_minima``, ``knn_fold_lazy``, ``scan_minout``),
so the two trees may differ in their C interfaces; each builds its kernels
into its own ``build/kernels/``.  On the SIFT-1M shape of chip_smoke.py
(1M x 128 points, 10,240 queries, seed 7) it times:

* capped at k=108 (tile 4096 rows, the route's passes), the main path's
  k=100 call, and whether the two trees give it the same sorted rdist and
  thr bits (``capped_bits_equal``; ids compared as sorted rows,
  ``capped_rows_ids_differ``, since the last row range to arrive merges
  the others in and an exact tie at the k-th value may fall either way);
* bcap at kb=18 (128 blocks a tile), the main path's k=10 call;
* the block minima of bcap2 and the subchunk minima of two_phase;
* fold_lazy at k_scan 18 (the opt-in fold_lazy k=10 call), and whether
  the two trees give it the same sorted rdist bits (``lazy_bits_equal``;
  both are fold's).

On the MST workload's points (chip_smoke.py's 1M x 8, seed 0xB0), with
core distances (0.15 u)^2, u uniform (seed 1), and a labelling of 64
components (an 8 x 8 grid over the first two features), written once by
this process and read by every side, it times the Borůvka scan
``scan_minout`` at chip_smoke.py's reduced shape (16,384 query rows x 1M)
and at one full round (1M x 1M), and its plain version on the host's CPU
(``scan_minout`` on CPU tensors) at one of that version's 4,096 x 16,384
tiles (the first 4,096 and 16,384 rows; ``*_cpu_ms``, one call each on
the host's clock).  The two trees' float32 bits may differ by design (a
fused or a separately rounded sum), so for each side it reports, against
the first parent turn, the largest bw difference in f32 ulp and the count
of bj that differ (``*_vs_parent``), and the largest distance of its bw
from the same edge's weight in float64 in ulp (``*_vs_f64``), with the SM
clock and power draw nvidia-smi read during the full rounds (medians of
100 ms samples).

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
KERNELS = ("knn_capped", "knn_bcap", "bcap_minima", "subchunk_minima",
           "knn_fold_lazy", "scan_minout")


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


def worker(tree: str, spec: dict, out: str) -> None:
    """One side: the kernels of the checkout at ``tree`` on the shape in
    ``spec``; writes {kernel: {"ms": [...], "plan": ...}} to ``out`` (JSON)
    and capped's and fold_lazy's sorted outputs beside it (``.npz``)."""
    sys.path.insert(0, tree)
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops.cuda import _build
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk
    from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as msk

    if not Path(pt.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {pt.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    rng = np.random.default_rng(spec["seed"])
    points = rng.random((spec["n"], spec["dim"]), dtype=np.float32) * 255.0
    queries = rng.random((spec["q"], spec["dim"]), dtype=np.float32) * 255.0
    index = pt.BruteForce.euclidean(points)
    qc = (torch.from_numpy(queries).cuda() - index._center).contiguous()
    pp, pn = index._pts, index._norms
    n, d = pp.shape
    nq = qc.shape[0]
    ck, ctile, cpasses = spec["capped"]
    bk, btile, bpasses = spec["bcap"]
    lk = spec["fold_lazy"][0]
    calls = {
        "knn_capped": lambda: kk.knn_capped(pp, qc, pn, k=ck, tile=ctile,
                                            passes=cpasses),
        "knn_bcap": lambda: kk.knn_bcap(pp, qc, pn, k=bk, tile=btile,
                                        passes=bpasses),
        "bcap_minima": lambda: mk.bcap_minima(pp, qc, pn),
        "subchunk_minima": lambda: mk.subchunk_minima(pp, qc, pn),
        "knn_fold_lazy": lambda: kk.knn_fold_lazy(pp, qc, pn, k=lk),
    }
    plans = {"knn_capped": kk.kernel_plan("capped", n, nq, d, ck, ctile),
             "knn_bcap": kk.kernel_plan("bcap", n, nq, d, bk, btile),
             "bcap_minima": mk.minima_plan("block", n, nq, d),
             "subchunk_minima": mk.minima_plan("subchunk", n, nq, d),
             "knn_fold_lazy": kk.kernel_plan("fold_lazy", n, nq, d, lk)}
    row = {name: {"ms": [cuda_ms(fn, reps=3) for _ in range(ROUNDS)],
                  "plan": plans[name]} for name, fn in calls.items()}
    rd, ids, thr = calls["knn_capped"]()
    lazy_rd, _ = calls["knn_fold_lazy"]()
    del index, qc, pp, pn, calls
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
    row["scan_minout"]["full_sm_mhz"], row["scan_minout"]["full_power_w"] = \
        smi.medians()
    cpu = tuple(a[:spec["cpu_q"] if i >= 3 else spec["cpu_n"]].cpu()
                for i, a in enumerate(full))
    row["scan_minout"]["cpu_ms"] = [host_ms(lambda: msk.scan_minout(*cpu))
                                    for _ in range(ROUNDS)]
    bw, bj = msk.scan_minout(*full)
    np.savez(out + ".npz",
             rdist=torch.sort(rd, 1).values.view(torch.int32).cpu().numpy(),
             ids=torch.sort(ids, 1).values.cpu().numpy(),
             thr=thr.view(torch.int32).cpu().numpy(),
             lazy_rdist=torch.sort(lazy_rd, 1).values.view(torch.int32)
             .cpu().numpy(),
             scan_bw=bw.cpu().numpy(), scan_bj=bj.cpu().numpy())
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

    spec = {"seed": cs.SEED, "n": cs.N, "dim": cs.DIM, "q": cs.N_Q,
            "capped": cs.kernel_args("capped", 100, cs.N),
            "bcap": cs.kernel_args("bcap", 10, cs.N),
            "fold_lazy": cs.kernel_args("fold_lazy", 10, cs.N),
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
    for name in KERNELS:
        row = {"kernel": name}
        for side in ("parent", "change"):
            mine = [r for s, r, _ in runs if s == side]
            row[f"{side}_ms"] = [ms for r in mine for ms in r[name]["ms"]]
            row[f"{side}_plan"] = mine[0][name]["plan"]
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
