"""device.idle_pct: 100 less the share of the profiled sub-window in which a
kernel, copy or fill ran on some stream of the card."""

from vo_bench import readings


def read(ctx):
    if not readings.traced(ctx):
        return None
    busy, window = readings.busy_and_window(ctx.profile)
    return 100.0 * (1.0 - busy / window)
