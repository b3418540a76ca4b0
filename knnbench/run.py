"""The benchmark of ``petal_neighbors_tpu_torch`` on NVIDIA cards.

    python3 knnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  One run makes the cell's data from the
seed, builds the index, warms the cell's shapes (all of that is
``setup_s``), measures for ``--seconds``, checks every answer of the
window against the plain reference, and prints one JSON line last on
standard output (the end-to-end metrics with ``--trace 0``, the per-layer
ones with ``--trace 1``).  The compared numbers and their limits are the
last lines on standard error and the result's last key.  Without a card,
or with fewer cards than the cell asks for, or with JAX loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]

#: top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "petal_neighbors_tpu")


def prepare() -> None:
    """Imports start at the checkout's root, not at this folder; kernel
    caches lie at fixed paths inside the checkout (the port's own nvcc
    builds go to ``build/kernels/`` there already)."""
    sys.path[0] = str(CHECKOUT)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(
        CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process), compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from knnbench import harness, spec
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"knnbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"knnbench: loaded in the process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result, notes = run["result"], run["notes"]
    notes["card"] = card_info()
    print("knnbench notes " + json.dumps(notes), flush=True)
    for m, c in result["checks"].items():
        print(f"check {m} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    prepare()
    sys.exit(main())
