"""api_idle_ms_per_query.single: the card's idle time (no kernel, copy or
memset) inside the index API's single-query call (the program's
``petal.query`` span, ``trees/bruteforce.py`` ``BruteForce.query``) and
outside the route's ``petal.route`` span, in milliseconds per profiled
query: validation, the query's upload, the scheme's pick and the
answers' copies.  Single-query cells only; nothing to read where the
program records no such spans."""

from knnbench import spans

UNIT = "ms"


def read(rec):
    if rec.mode != "single" or not rec.queries or not rec.device:
        return None
    query = spans.intervals(rec, spans.QUERY)
    route = spans.intervals(rec, spans.ROUTE)
    if not query or not route:
        return None
    idle = (spans.idle_us(rec, query)
            - spans.idle_us(rec, spans.intersect(query, route)))
    return idle * 1e-3 / rec.queries
