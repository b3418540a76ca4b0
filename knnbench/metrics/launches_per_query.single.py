"""launches_per_query.single: kernels, copies and memsets that ran on the
card in the profiled stretch, per query.  Single-query cells only."""

UNIT = "launches"


def read(rec):
    if rec.mode != "single" or not rec.queries or not rec.device:
        return None
    return len(rec.device) / rec.queries
