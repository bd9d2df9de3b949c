"""keypoint_stereo_roofline: B2 (the fused per-keypoint stereo step)
against its bound, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("keypoint_stereo",))
