"""route_idle_ms_per_query.single: the card's idle time (no kernel, copy
or memset) inside the route (the program's ``petal.route`` span,
``ops/bruteforce.py`` ``knn_prepadded``), in milliseconds per profiled
query.  Single-query cells only; nothing to read where the program
records no such span."""

from knnbench import spans

UNIT = "ms"


def read(rec):
    if rec.mode != "single" or not rec.queries or not rec.device:
        return None
    route = spans.intervals(rec, spans.ROUTE)
    if not route:
        return None
    return spans.idle_us(rec, route) * 1e-3 / rec.queries
