"""kernels_roofline: the hand-written kernels' bound time over their device
time in the profiled frames, in %."""

from vo_bench import readings


def read(ctx):
    return readings.roofline_pct(ctx, ("patches", "keypoint_stereo", "matcher", "cost_volumes", "sgm",
                                       "local_ba_blocks"))
