"""merge_ms_per_batch.batch: the device time of the kernels launched
under the route's calls of the merge kernel (the program's
``petal.route.merge`` span: ``ops/cuda/knn_kernel.py`` ``knn_merge``, the
radix select of ``csrc/knn_select.cu`` and its word sort), in
milliseconds per profiled batch.  Batch cells only; nothing to read where
the program records no such span (a cell off the merge scheme, or a
program without the span)."""

from knnbench import spans

UNIT = "ms"

#: the program's span around each route call of ``knn_merge``
MERGE = "petal.route.merge"


def read(rec):
    if rec.mode != "batch":
        return None
    return spans.kernel_ms_per_step(rec, MERGE)
