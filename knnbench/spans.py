"""The program's own spans and counters, as the per-layer readers read
them.

The port records ``petal.*`` spans around its k-NN path while a profiler
runs (``petal_neighbors_tpu_torch.utils.profiling``), so a traced run's
Chrome trace holds them beside the benchmark's own ``knnbench.*`` spans,
and keeps integer counters in memory.  A checkout whose program records
neither gives the readers nothing to read: each returns None there.
"""

from __future__ import annotations

from .trace import _covered, _merge

QUERY = "petal.query"
ROUTE = "petal.route"
RESCORE = "petal.route.rescore"
REPAIR = "petal.route.repair"


def kernel_ms_per_step(rec, span: str):
    """Device time of the kernels launched under ``span``, in ms per
    profiled step; None where the stretch holds no such span or no device
    activity."""
    if not rec.steps or not rec.device or rec.span_count(span) == 0:
        return None
    us = sum(float(e["dur"]) for e in rec.kernels_launched_in(span))
    return us * 1e-3 / rec.steps


def intervals(rec, span: str):
    """The stretch's ``span`` events as merged [start, end] intervals,
    clipped to the profiled steps."""
    return [iv for iv in _merge(
        (max(rec.t0, float(e["ts"])),
         min(rec.t1, float(e["ts"]) + float(e["dur"])))
        for e in rec.host if e.get("name") == span) if iv[1] > iv[0]]


def intersect(a, b):
    """The intersection of two lists of merged intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_us(rec, ivs) -> float:
    """Time inside the intervals in which no kernel, copy or memset ran on
    the card."""
    busy = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in rec.device)
    return sum((b - a) - _covered(busy, a, b) for a, b in ivs)


def program_counters():
    """The program's counters in this process, or None where the program
    keeps none."""
    from petal_neighbors_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    return None if read is None else read()
