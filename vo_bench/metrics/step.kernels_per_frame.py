"""step.kernels_per_frame: device kernels a frame (every stream's) in the
profiled sub-window."""

from vo_bench import readings


def read(ctx):
    return readings.kernels_per_iteration(ctx)
