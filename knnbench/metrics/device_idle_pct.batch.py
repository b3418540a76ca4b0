"""device_idle_pct.batch: the share of the profiled stretch in which no
kernel or copy ran on the card, in percent.  Batch cells only."""

UNIT = "%"


def read(rec):
    if rec.mode != "batch" or not rec.device or rec.window_us() <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_us() / rec.window_us())
