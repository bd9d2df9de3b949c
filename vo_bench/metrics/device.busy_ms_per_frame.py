"""device.busy_ms_per_frame: the union of kernel, copy and fill intervals
over every stream in the profiled sub-window, in ms a frame."""

from vo_bench import readings


def read(ctx):
    if not readings.traced(ctx):
        return None
    return readings.busy_and_window(ctx.profile)[0] * 1e3 / ctx.profile.frames
