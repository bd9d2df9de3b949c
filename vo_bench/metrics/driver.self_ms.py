"""driver.self_ms: host ms a frame inside the pipeline's ``process_frame``
(uploads into the static buffers, the wait on frame t-1's readback,
bookkeeping), less the Step layer's spans inside it."""

from vo_bench import readings


def read(ctx):
    return readings.span_ms_per_iteration(ctx, "driver", minus="step")
