"""repaired_per_1000.batch: the queries that the route's proof left to the
repair, per 1,000 queries routed, from the program's counters
(``route.repaired`` over ``route.queries``).  The counters run over the
whole traced process, warm-up and window alike, all drawn from the one
pool the cell cycles through: a larger sample than the profiled stretch.
Batch cells only; nothing to read where the program keeps no such
counters or its proof never ran."""

from knnbench import spans

UNIT = "queries"


def read(rec):
    if rec.mode != "batch" or not rec.steps or not rec.device:
        return None
    c = spans.program_counters()
    if not c or "route.repaired" not in c or not c.get("route.queries"):
        return None
    return 1000.0 * c["route.repaired"] / c["route.queries"]
