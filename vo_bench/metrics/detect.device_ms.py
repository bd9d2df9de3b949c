"""detect.device_ms: device ms a frame of the kernels on the detection stream
(the detect graph's replay on the pipeline's side stream: its convolutions
and NMS), the union of their intervals in the profiled frames."""

from vo_bench import readings, stats


def read(ctx):
    kernels = readings.detection_kernels(ctx)
    if kernels is None or not kernels[0]:
        return None
    return stats.union_length(kernels[0]) / 1e3 / ctx.profile.frames
