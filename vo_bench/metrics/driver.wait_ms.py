"""driver.wait_ms: host ms a frame inside the pipeline's ``_finalize``: the
wait on frame t-1's readback event and the trajectory append after it.
Near the frame's time where the device paces the loop, near 0 where the
host does."""

from vo_bench import readings


def read(ctx):
    return readings.span_ms_per_iteration(ctx, "driver.wait")
