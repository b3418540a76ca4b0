"""Readings that the benchmark's limits and rates were set from, on the card.

    python3 knnbench/calibrate.py readings --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds <s>
    python3 knnbench/calibrate.py sweep --workload <cell> --seed <n> \\
        --rates closed,200,300 --seconds <s>

``readings`` runs the cell's set-up, a window of ``--seconds`` and the
check once a seed, all in one process, and prints each seed's compared
numbers: first the program's, then the control's (the plain reference in
the program's place, computed in TF32), whose numbers a sound comparison
has to call wrong.  A single-query cell runs its window as a closed loop
here (the answers do not depend on the pacing), so a short window
compares as many answers as a run does.  ``sweep`` runs a single-query
cell at each rate ("closed" for the closed loop, whose rate is the most
one client can get) and prints the window's notes.  The benchmark's own
runs call neither.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def _line(kind, run, extra=None):
    r = run["result"]
    out = {"kind": kind, "seed": run["notes"]["seed"],
           "checks": {m: c["value"] for m, c in r["checks"].items()},
           "attempted": r["attempted"], "failed": r["failed"],
           "metrics": {m: v["value"] for m, v in r["metrics"].items()},
           **(extra or {})}
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="closed")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from knnbench import harness, spec
    cell = spec.cell(args.workload)
    mode = cell["traffic"]["mode"]
    closed = {"rate_qps": None} if mode == "single" else None
    print(json.dumps({"card": torch.cuda.get_device_name(0)
                      if args.device == "cuda" else "cpu",
                      "torch": torch.__version__}), flush=True)
    if args.what == "sweep":
        for r in args.rates.split(","):
            rate = None if r == "closed" else float(r)
            run = harness.run_cell(args.workload, args.seed, args.seconds,
                                   False, device=args.device,
                                   traffic_update={"rate_qps": rate})
            _line("sweep", run, {"rate_qps": rate,
                                 "notes": run["notes"]})
        return 0
    reference = harness.reference_of(spec.mode(mode), cell["config"])

    def control(points, config, device):
        return harness.ReferenceIndex(reference, points, "tf32")

    for kind, seeds, factory in (
            ("program", args.seeds, None),
            ("control", args.control_seeds, control)):
        for s in filter(None, seeds.split(",")):
            t = time.perf_counter()
            run = harness.run_cell(args.workload, int(s), args.seconds,
                                   False, device=args.device,
                                   index_factory=factory,
                                   traffic_update=closed)
            _line(kind, run, {"run_s": time.perf_counter() - t,
                              "setup_s": run["notes"]["setup_s"]})
    return 0


if __name__ == "__main__":
    sys.path[0] = str(CHECKOUT)
    sys.exit(main())
