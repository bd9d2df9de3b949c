"""dp.self_ms: host ms a step inside the dp tracker's ``step`` and the wait
on the previous step's pose readback, less the Step layer's spans inside."""

from vo_bench import readings


def read(ctx):
    return readings.span_ms_per_iteration(ctx, "dp", minus="step")
