"""repair_ms_per_batch.batch: the device time of the kernels launched
under the route's repair (``ops/bruteforce.py`` ``_prove_repair``, wrapped
in a span by the traced run), in milliseconds per profiled batch.  Batch
cells only; nothing to read where the wrapper was not in place or the
route never reached the repair."""

from knnbench.trace import REPAIR_SPAN

UNIT = "ms"


def read(rec):
    if rec.mode != "batch" or not rec.repair_probe or not rec.steps:
        return None
    if rec.span_count(REPAIR_SPAN) == 0:
        return None
    us = sum(float(e["dur"]) for e in rec.kernels_launched_in(REPAIR_SPAN))
    return us * 1e-3 / rec.steps
