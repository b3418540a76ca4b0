"""Helpers shared by the harness's tests."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: a configuration small enough for the CPU: the port's plain versions
#: serve it
TINY = {"name": "tiny", "source": "the harness's tests", "n": 8192, "d": 40,
        "queries": 64, "metric": "euclidean", "dtype": "float32",
        "values": {"distribution": "uniform", "low": 0.0, "high": 255.0},
        "data_seed": 7, "assumed": [], "reduced": []}
TINY_LIMITS = {"rank_gap": 1e-5, "id_gap": 1e-5, "bad_ids": 0}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


def make_tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark's folder with a tiny configuration and two
    cells on it, ``tiny.batch`` and ``tiny.single`` (closed loop)."""
    root = tmp_path / "knnbench"
    shutil.copytree(CHECKOUT / "knnbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write_json(root / "configs" / "tiny.json", TINY)
    write_json(root / "traffic" / "tiny-batch.json",
               {"mode": "batch", "k": 10, "batch": "published", "pool": 640,
                "warmup_steps": 2, "trace_warmup_steps": 2,
                "trace_steps": 20})
    write_json(root / "traffic" / "tiny-single.json",
               {"mode": "single", "k": 10, "rate_qps": None, "pool": 128,
                "warmup_batch": 128, "warmup_steps": 2, "trace_warmup_steps": 1,
                "trace_steps": 5})
    for cell, traffic in (("tiny.batch", "tiny-batch"),
                          ("tiny.single", "tiny-single")):
        write_json(root / "workloads" / f"{cell}.json",
                   {"config": "tiny", "traffic": traffic, "chips": 1,
                    "why": "the harness's tests", "limits": TINY_LIMITS})
    return root
