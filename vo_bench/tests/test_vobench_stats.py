"""The arithmetic of the end-to-end metrics and of the device trace."""

import numpy as np
import pytest

from vo_bench import readings, stats
from vo_bench.trace import Profile, Spans


def test_p95_is_over_every_iteration_not_over_chunk_medians():
    # 100 iterations of 10 ms and 10 stalls of 100 ms, the stalls in one chunk
    its = [0.010] * 100 + [0.100] * 10
    assert stats.p95_ms(its) == pytest.approx(float(np.percentile(np.array(its), 95)) * 1e3)
    assert stats.p95_ms(its) == pytest.approx(100.0)
    chunks = [np.median(its[i:i + 10]) for i in range(0, len(its), 10)]
    assert np.percentile(chunks, 95) * 1e3 < 60.0  # what a median of chunks would hide
    with pytest.raises(ValueError):
        stats.p95_ms([])


def test_rate_counts_every_frame_delivered_inside_the_window_over_its_seconds():
    t0 = 100.0
    delivered = [t0 + 0.1 * k for k in range(1, 31)] + [t0 + 3.05]   # the last after the window
    assert stats.frames_per_s(delivered, t0, 3.0, streams=1) == pytest.approx(30 / 3.0)
    assert stats.frames_per_s(delivered, t0, 3.0, streams=4) == pytest.approx(120 / 3.0)
    # a stall inside the window lowers the rate: fewer frames, the same seconds
    stalled = [t0 + 0.1 * k for k in range(1, 11)] + [t0 + 2.9]
    assert stats.frames_per_s(stalled, t0, 3.0, streams=1) == pytest.approx(11 / 3.0)


def test_rate_bins_give_each_slice_its_own_rate_and_sum_to_the_window():
    t0 = 50.0
    delivered = [t0 + 0.1 * k for k in range(50)] + [t0 + 5.0 + 0.5 * k for k in range(9)] + [t0 + 10.5, t0 + 12.5]
    bins = stats.rate_bins(delivered, t0, 11.0, 5.0, streams=2)
    assert bins == pytest.approx([2 * 50 / 5.0, 2 * 9 / 5.0, 2 * 1 / 1.0])   # a stall shows in its slice
    assert sum(b * w for b, w in zip(bins, (5.0, 5.0, 1.0))) == pytest.approx(
        stats.frames_per_s(delivered, t0, 11.0, streams=2) * 11.0)


def test_union_gaps_and_self_time_on_hand_made_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 9.0)]
    assert stats.union(iv) == [(0.0, 3.0), (5.0, 6.0), (8.0, 9.0)]
    assert stats.union_length(iv) == pytest.approx(5.0)
    assert stats.gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 8.0), (9.0, 10.0)]
    assert stats.gaps(iv, 1.0, 5.5) == [(3.0, 5.0)]
    assert stats.self_seconds([(0.0, 10.0)], [(1.0, 3.0), (2.0, 4.0), (9.0, 12.0)]) == pytest.approx(6.0)


def hand_profile():
    """A 10 ms sub-window of 2 frames: kernels on two streams overlap, a
    copy, gaps under the spans "driver" and "step"."""
    p = Profile(2)
    p.frames, p.window_s, p.t0 = 2, 0.010, 0.0
    p.device = [("extract_patches_levels_kernel", "kernel", 1000.0, 1000.0),
                ("fused_best_match_kernel", "kernel", 1500.0, 1000.0),   # overlaps the first
                ("Memcpy HtoD", "gpu_memcpy", 4000.0, 500.0),
                ("fused_best_match_kernel", "kernel", 7000.0, 2000.0)]
    p.ranges = [("iteration", 0.0, 5000.0), ("driver", 200.0, 4700.0), ("step", 3000.0, 500.0),
                ("iteration", 5000.0, 5000.0), ("driver", 5100.0, 4800.0)]
    return p


def test_idle_share_busy_and_breakdown_on_a_hand_made_trace():
    p = hand_profile()
    busy, window = readings.busy_and_window(p)
    assert busy == pytest.approx((1.5e-3 + 0.5e-3 + 2.0e-3))   # the union, not the sum
    assert window == 0.010
    assert 100 * (1 - busy / window) == pytest.approx(60.0)
    b = readings.breakdown(p)
    assert b["device_ops"][0] == ["fused_best_match_kernel", pytest.approx(3e-3)]
    assert len(b["device_ops"]) == 3
    gaps = b["idle_gaps"]
    # gaps: 0-1000 (driver from 200 / iteration), 2500-4000 (step at its middle 3250),
    # 4500-7000 (driver of iteration 2 at 5750), 9000-10000 (driver)
    assert gaps[0] == ["driver", pytest.approx(2.5e-3)]
    assert ["step", pytest.approx(1.5e-3)] in gaps
    ctx = type("C", (), {})()
    ctx.profile, ctx.streams = p, 1
    assert readings.kernels_per_iteration(ctx) == 1.5


def test_spans_record_the_host_time_of_wrapped_methods():
    spans = Spans()

    class Obj:
        def go(self, x):
            return x + 1

    o = Obj()
    spans.wrap(o, "go", "step")
    with spans("iteration"):
        with spans("driver"):
            assert o.go(1) == 2
    assert [n for n, _, _ in spans.items] == ["step", "driver", "iteration"]
    ctx = type("C", (), {})()
    ctx.spans, ctx.profile = spans, None
    assert readings.span_ms_per_iteration(ctx, "driver", minus="step") >= 0.0
    assert readings.span_ms_per_iteration(ctx, "nothing") is None
