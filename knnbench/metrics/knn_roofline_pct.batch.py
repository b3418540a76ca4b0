"""knn_roofline_pct.batch: the profiled batches' least time on the card
(``knnbench.roofline``: the search's 2·Q·N·d operations at the bf16
tensor-core peak, or its bytes once, whichever is larger) over the device
time of every kernel launched in them, the library's and the port's
alike, in percent.  Batch cells only."""

from knnbench import roofline

UNIT = "%"


def read(rec):
    if rec.mode != "batch" or not rec.queries:
        return None
    kernel_s = rec.kernel_us() * 1e-6
    if kernel_s <= 0:
        return None
    cfg = rec.config
    return 100.0 * roofline.least_seconds(
        rec.queries, cfg["n"], cfg["d"], int(rec.traffic["k"])) / kernel_s
