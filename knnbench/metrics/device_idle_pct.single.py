"""device_idle_pct.single: the share of the profiled stretch, less the
driver's waits for the next query's due time, in which no kernel or copy
ran on the card, in percent: the card's idle time while a query was being
served.  Single-query cells only."""

UNIT = "%"


def read(rec):
    if rec.mode != "single" or not rec.device or rec.serving_us() <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_serving_us() / rec.serving_us())
