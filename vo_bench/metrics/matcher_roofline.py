"""matcher_roofline: B3 (the fused Hamming matcher, two calls a tracked
frame) against its bound, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("matcher",))
