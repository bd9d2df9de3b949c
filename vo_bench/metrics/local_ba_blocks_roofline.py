"""local_ba_blocks_roofline: B7 (the local-BA block build, five a window
refine) against its bound, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("local_ba_blocks",))
