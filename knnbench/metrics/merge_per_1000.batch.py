"""merge_per_1000.batch: the queries that the merge kernel served, per
1,000 queries routed, from the program's counters (``knn.merge_queries``
over ``route.queries``).  The counters run over the whole traced process,
warm-up and window alike.  Batch cells only; nothing to read where the
program keeps no such counter or never called the merge kernel."""

from knnbench import spans

UNIT = "queries"


def read(rec):
    if rec.mode != "batch" or not rec.steps or not rec.device:
        return None
    c = spans.program_counters()
    if not c or "knn.merge_queries" not in c or not c.get("route.queries"):
        return None
    return 1000.0 * c["knn.merge_queries"] / c["route.queries"]
