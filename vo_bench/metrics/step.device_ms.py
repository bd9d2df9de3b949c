"""step.device_ms: device ms a loop iteration covered by the step graphs'
replays, each from its first stamp to its last, over the unprofiled iterations
before the profiler: their sum in the stream1 cells, where they run one after
another, and the union of the streams' replays in the fleet. It is read with
this file as ``step.device_ms.fleet``."""


def read(ctx):
    try:
        from stereo_semantic_vo_tpu_torch.utils.profiling import reading
    except ImportError:  # a program without the tracer
        return None
    if ctx.spans is None:
        return None
    before = None if ctx.profile is None else ctx.profile.started
    return reading(ctx.spans.of("iteration"), before, "step_ms")
