"""detect.overlap_pct: the share of the detection stream's kernel time during
which a kernel of another stream (the step's) runs too, in the profiled
frames, in %: 0 where detection runs in the step's gaps, 100 where it hides
under the step's kernels.  The profiler does not keep two streams' kernels
apart (``tests/test_vobench_detect_trace.py``: two spin kernels, launched
or replayed as graphs, read above 90% here as without the profiler by the
host's clock); unprofiled, the step's stamps against ``sparse.stream1``'s
on the same seeds show the same (PERF.md, section 3)."""

from vo_bench import readings, stats


def read(ctx):
    kernels = readings.detection_kernels(ctx)
    if kernels is None or not kernels[0]:
        return None
    det, other = kernels
    mine = stats.union_length(det)
    both = mine + stats.union_length(other) - stats.union_length(det + other)
    return 100.0 * both / mine
