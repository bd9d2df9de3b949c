"""driver.append_ms: host ms a loop iteration in the program's span
``pipeline.append``: the trajectory writer's append of frame t-1 (formatting,
two writes and two flushes), over the iterations before the profiler."""


def read(ctx):
    try:
        from stereo_semantic_vo_tpu_torch.utils.profiling import reading
    except ImportError:  # a program without the tracer
        return None
    if ctx.spans is None:
        return None
    before = None if ctx.profile is None else ctx.profile.started
    return reading(ctx.spans.of("iteration"), before, "span_ms", "pipeline.append")
