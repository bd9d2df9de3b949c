"""patches_roofline: B1 (every level's patches in one launch) against its
bound, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("patches",))
