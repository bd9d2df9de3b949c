"""cost_volumes_roofline: the dense cost volumes' kernel (both volumes of a
frame in one launch) against its bound, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("cost_volumes",))
