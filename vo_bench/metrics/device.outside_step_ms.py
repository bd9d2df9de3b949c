"""device.outside_step_ms: device-clock ms from one loop iteration's first
stamp to the next iteration's, less its replays: the uploads, clones, readback
copies and idle between the steps, with no profiler running."""


def read(ctx):
    try:
        from stereo_semantic_vo_tpu_torch.utils.profiling import reading
    except ImportError:  # a program without the tracer
        return None
    if ctx.spans is None:
        return None
    before = None if ctx.profile is None else ctx.profile.started
    return reading(ctx.spans.of("iteration"), before, "outside_step_ms")
