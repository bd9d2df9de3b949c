"""sgm_roofline: B6 (SGM's sweeps and sum, three volumes a dense frame)
against its bound, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("sgm",))
