"""rescore_ms_per_batch.batch: the device time of the kernels launched
under the route's rescore (the program's ``petal.route.rescore`` span:
``ops/bruteforce.py`` ``_block_rescore``, ``_bcap_rescore_large`` and
``_rerank``), in milliseconds per profiled batch.  Batch cells only;
nothing to read where the program records no such span."""

from knnbench import spans

UNIT = "ms"


def read(rec):
    if rec.mode != "batch":
        return None
    return spans.kernel_ms_per_step(rec, spans.RESCORE)
