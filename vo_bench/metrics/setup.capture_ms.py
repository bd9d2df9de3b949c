"""setup.capture_ms: the summed milliseconds of every CUDA graph capture of
the process (``core/cuda_graph.Graph``), as the program's tracer counts
them."""


def read(ctx):
    try:
        from stereo_semantic_vo_tpu_torch.utils.profiling import traced
    except ImportError:  # a program without the tracer
        return None
    trace = traced()
    return trace.capture_ms if trace.captures else None
