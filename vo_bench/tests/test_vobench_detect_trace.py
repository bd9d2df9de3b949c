"""The Detector layer's readers on a hand-made trace: the detection stream is
the one that kernels launched inside the harness's ``detect`` spans run on
(a graph replay's kernels carry its launch's correlation id), its device
time is the union of those kernels, its overlap the share of it under
another stream's kernels; ``detector.mfu`` is the cfg's FLOPs over the mean
unprofiled iteration at 67 TFLOP/s.  A run with no detection reads
nothing."""

import os
import time
from types import SimpleNamespace

import pytest
import torch

from vo_bench import bench, roofline, stats
from vo_bench.trace import Profile, Spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DET, MAIN = 13, 7


def readers(cell):
    c = bench.find_cell(cell, ROOT)
    return c, {m["name"]: mod for m, mod in c.per_layer}


def traced(detect=True):
    p = Profile(2)
    p.frames, p.started = 2, 50.0
    for f in range(2):
        at = 1000.0 * f
        if detect:
            p.ranges.append(("detect", at + 100, 10))
            p.launches.append(("cudaGraphLaunch", at + 105, 2, 10 + 10 * f))
            p.device.append(("cudnn_conv", "kernel", at + 200, 100))          # the detect graph's kernel
            p.streams.append((DET, 10 + 10 * f))
        p.ranges.append(("step", at + 112, 5))
        p.launches.append(("cudaGraphLaunch", at + 114, 2, 11 + 10 * f))
        p.device.append(("track_kernel", "kernel", at + 250 + 1050 * f, 150 + 50 * f))   # the step's, on the main stream
        p.streams.append((MAIN, 11 + 10 * f))
        p.device.append(("Memcpy HtoD", "gpu_memcpy", at + 150, 400))
        p.streams.append((MAIN, -1))
    return p


def test_the_detection_streams_time_and_overlap():
    cell, read = readers("online.stream1")
    ctx = SimpleNamespace(cell=cell, profile=traced(), spans=None, streams=1)
    assert read["detect.device_ms"].read(ctx) == pytest.approx((100 + 100) / 1e3 / 2)
    # frame 0: the step's kernel covers 250-300 of the detection's 200-300; frame 1: none of 1200-1300
    assert read["detect.overlap_pct"].read(ctx) == pytest.approx(100.0 * 50 / 200)


def test_no_detection_reads_nothing():
    cell, read = readers("online.stream1")
    ctx = SimpleNamespace(cell=cell, profile=traced(detect=False), spans=None, streams=1)
    assert read["detect.device_ms"].read(ctx) is None and read["detect.overlap_pct"].read(ctx) is None
    sparse, _ = readers("sparse.stream1")
    assert "detector.mfu" not in {m["name"] for m, _ in sparse.per_layer}


def test_detector_mfu_is_the_model_flops_over_the_unprofiled_iteration():
    cell, read = readers("online.stream1")
    spans = Spans()
    spans.items += [("iteration", 10.0 + 0.014 * k, 10.0 + 0.014 * (k + 1)) for k in range(10)]
    ctx = SimpleNamespace(cell=cell, profile=SimpleNamespace(started=10.0 + 0.014 * 6), spans=spans, streams=1)
    flops = roofline.detector_flops(cell.config["detector"]["cfg_text"])
    assert read["detector.mfu"].read(ctx) == pytest.approx(100.0 * flops / (0.014 * 67e12))   # ~0.41%
    assert read["detector.mfu"].read(SimpleNamespace(cell=cell, profile=None, spans=None, streams=1)) is None


@pytest.mark.parametrize("graphs", [False, True])
def test_the_profile_shows_two_streams_kernels_running_together(graphs):
    """On a card: two spin kernels of one block each, on two streams (as
    launches, or each a replayed CUDA graph like the step's and the detect
    graph), run at once without the profiler, by the host's clock, and
    ``Profile``'s trace shows them overlapping as ``detect.overlap_pct``
    measures it: the tracing keeps the streams' kernels apart no more than
    the card does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cycles = 40_000_000   # ~20 ms at 1.98 GHz
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    launches = [lambda: torch.cuda._sleep(cycles)] * 2
    if graphs:
        launches = []
        for s in streams:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                torch.cuda._sleep(cycles)
            launches.append(g.replay)

    def run(k: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s, go in list(zip(streams, launches))[:k]:
            with torch.cuda.stream(s):
                go()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)
    one, two = run(1), run(2)
    assert two < 1.3 * one, (one, two)   # together, not in turns
    p = Profile(1)
    p.start()
    run(2)
    p.stop(1)
    spins = [(stream, a, b) for stream, a, b in p.kernel_intervals() if b - a > 0.5 * one * 1e6]
    assert len({stream for stream, _, _ in spins}) == 2, spins
    a, b = ([(t0, t1) for stream, t0, t1 in spins if stream == s] for s in sorted({st for st, _, _ in spins}))
    both = stats.union_length(a) + stats.union_length(b) - stats.union_length(a + b)
    assert both / stats.union_length(a) > 0.9, spins
