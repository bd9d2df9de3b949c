"""step.host_ms: host ms a frame (every stream's) inside the ``init`` /
``track`` / ``refine`` calls of the program's ``StepGraphs``: the graph
replays' launch on the host."""

from vo_bench import readings


def read(ctx):
    return readings.span_ms_per_iteration(ctx, "step")
