"""normalize_ms_per_batch.batch: the device time of the kernels launched
under the route's query normalisation (the program's
``petal.route.normalize`` span inside ``petal.route.prep``:
``ops/bruteforce.py`` ``knn_prepadded(normalize_q=True)``, a cosine
index's queries over their norms), in milliseconds per profiled batch.
Batch cells only; nothing to read where the program records no such span
(a Euclidean index, or a program without the span)."""

from knnbench import spans

UNIT = "ms"

#: the program's span around the normalisation
NORMALIZE = "petal.route.normalize"


def read(rec):
    if rec.mode != "batch":
        return None
    return spans.kernel_ms_per_step(rec, NORMALIZE)
