"""ops.map.device_ms: device ms a loop iteration in the step's the map and
state writes, the graph's state copy-back included: from the stage's stamp to
the next on the card's timer, summed over the iteration's replays, over the
unprofiled iterations before the profiler."""


def read(ctx):
    try:
        from stereo_semantic_vo_tpu_torch.utils.profiling import reading
    except ImportError:  # a program without the tracer
        return None
    if ctx.spans is None:
        return None
    before = None if ctx.profile is None else ctx.profile.started
    return reading(ctx.spans.of("iteration"), before, "stage_ms", "map")
