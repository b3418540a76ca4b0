"""route_repair_ms_per_batch.batch: the device time of the kernels
launched under the route's repair (the program's ``petal.route.repair``
span, the whole body of ``ops/bruteforce.py`` ``_prove_repair``), in
milliseconds per profiled batch.  Batch cells only; nothing to read where
the program records no such span."""

from knnbench import spans

UNIT = "ms"


def read(rec):
    if rec.mode != "batch":
        return None
    return spans.kernel_ms_per_step(rec, spans.REPAIR)
