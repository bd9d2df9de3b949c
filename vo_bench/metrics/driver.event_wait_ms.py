"""driver.event_wait_ms: host ms a loop iteration in the program's span
``pipeline.wait``: the wait on frame t-1's readback event alone, over the
iterations before the profiler."""


def read(ctx):
    try:
        from stereo_semantic_vo_tpu_torch.utils.profiling import reading
    except ImportError:  # a program without the tracer
        return None
    if ctx.spans is None:
        return None
    before = None if ctx.profile is None else ctx.profile.started
    return reading(ctx.spans.of("iteration"), before, "span_ms", "pipeline.wait")
