"""Time two checkouts' u-domain kernels on one card, in turns.

    python3 kernel_ab.py --parent <root of the other checkout>

The other checkout is, for instance, an earlier commit unpacked with
``git archive <commit> | tar -x -C build/ab/parent``.  Each side runs in a
process of its own that imports that checkout's ``petal_neighbors_tpu_torch``
and calls its wrappers as a user would (``knn_capped``, ``knn_bcap``,
``bcap_minima``, ``subchunk_minima``, ``knn_fold_lazy``), so the two trees
may differ in their C interfaces; each builds its kernels into its own
``build/kernels/``.  On the SIFT-1M shape of chip_smoke.py (1M x 128
points, 10,240 queries, seed 7) it times:

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROUNDS = 3
KERNELS = ("knn_capped", "knn_bcap", "bcap_minima", "subchunk_minima",
           "knn_fold_lazy")


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


def worker(tree: str, spec: dict, out: str) -> None:
    """One side: the kernels of the checkout at ``tree`` on the shape in
    ``spec``; writes {kernel: {"ms": [...], "plan": ...}} to ``out`` (JSON)
    and capped's and fold_lazy's sorted outputs beside it (``.npz``)."""
    sys.path.insert(0, tree)
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops.cuda import _build
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

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
    np.savez(out + ".npz",
             rdist=torch.sort(rd, 1).values.view(torch.int32).cpu().numpy(),
             ids=torch.sort(ids, 1).values.cpu().numpy(),
             thr=thr.view(torch.int32).cpu().numpy(),
             lazy_rdist=torch.sort(lazy_rd, 1).values.view(torch.int32)
             .cpu().numpy())
    Path(out).write_text(json.dumps(row))


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
            "fold_lazy": cs.kernel_args("fold_lazy", 10, cs.N)}
    trees = {"parent": str(Path(args.parent).resolve()), "change": str(ROOT)}
    runs = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for turn, side in enumerate(("parent", "change", "change",
                                     "parent")):
            out = os.path.join(tmp, f"{turn}.json")
            subprocess.run([sys.executable, __file__, "--worker",
                            trees[side], "--spec", json.dumps(spec),
                            "--out", out], check=True, timeout=900)
            runs.append((side, json.loads(Path(out).read_text()),
                         dict(np.load(out + ".npz"))))
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
        if name == "knn_fold_lazy":
            row["lazy_bits_equal"] = all(
                np.array_equal(runs[0][2]["lazy_rdist"], out["lazy_rdist"])
                for _, _, out in runs)
        print(json.dumps(row), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
