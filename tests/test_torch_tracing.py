"""The port's tracer (``utils/profiling``) on the CPU.

The step's stages write their stamps into a ring of the same layout as on
the card, on the host's clock: the rings of a pipeline's init, track and
refine receive the stages in the tracker's order, tile each call, and wrap
at their depth; switching the tracer off changes no state or output, bit
for bit.  ``collect()``'s per-iteration readings are checked on hand-made
stamps (stage, step, outside-step, the union of the streams' calls, span
means, the iterations a wrapped ring still holds, the stages' means a
frame), and ``traced()`` copies once while nothing new is recorded.
Program spans keep their intervals in a bounded ring; with no profiler
running no ``record_function`` is entered, under a CPU ``torch.profiler``
the spans appear by name.  Off, nothing is recorded.  Small shapes (320x120, 128
keypoints) keep each test to seconds."""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu_torch.core.config import CameraConfig, VOConfig
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import VOState
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput
from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
from stereo_semantic_vo_tpu_torch.parallel.dp_tracker import batched_init_state, make_dp_tracker
from stereo_semantic_vo_tpu_torch.utils import profiling
from stereo_semantic_vo_tpu_torch.utils.profiling import RingRecord, Trace
from tests.torch_parity import one_torch_thread  # noqa: F401

H, W = 120, 320
TRACK = ["orb", "stereo", "match", "pnp", "lm", "map", "end"]


def _cfg() -> VOConfig:
    k = VOConfig.kitti()
    return dataclasses.replace(k, camera=CameraConfig(width=W, height=H, cx=W / 2, cy=H / 2),
                               orb=dataclasses.replace(k.orb, max_keypoints=128, n_levels=3, grid_rows=2,
                                                       grid_cols=4))


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts from an empty tracer that is on, and leaves it on."""
    profiling.clear()
    profiling.enable(True)
    yield
    profiling.enable(True)
    profiling.clear()


def _run(n: int, every: int = 0, traced: bool = True) -> VOPipeline:
    cfg = _cfg()
    profiling.enable(traced)
    pipe = VOPipeline(cfg, device="cpu", local_ba_every=every, write_trajectory=False)
    src, nb = two_plane_frame_source(H, W), cfg.semantic.max_boxes
    for i in range(n):
        boxes, valid = np.zeros((nb, 4), np.float32), np.zeros(nb, bool)
        if i == 2:  # the culling stage's in-box branch
            boxes[0], valid[0] = [100.0, 20.0, 200.0, 100.0], True
        pipe.process_frame(*src(i), boxes, valid, 0.1 * i)
    pipe.flush()
    profiling.enable(True)
    return pipe


@pytest.mark.parametrize("every", [0, 1])
def test_tracing_on_and_off_give_bit_identical_runs(every):
    """Five frames (with ``every``, a refine a frame once the window is
    full) with the tracer on and off: every output and the final state
    equal bit for bit; off, the pipeline holds no ring."""
    on, off = _run(5, every), _run(5, every, traced=False)
    assert set(on.steps.rings) == {"init_step", "track_step", "refine_state"} and off.steps.rings == {}
    assert len(on.outputs) == len(off.outputs) == 5
    for a, b in zip(on.outputs, off.outputs):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
    for name, x, y in zip(VOState._fields, on.state, off.state):
        assert torch.equal(x, y), name


def test_cpu_rings_receive_the_stages_in_order_and_tile_each_call():
    """A sparse pipeline with a refine a frame: one row a call, the
    tracker's stages in order then ``end``, stamps rising through each call
    and from one call of a ring to the next, the stages summing to the
    call; the ring's count equals its calls, one a frame from the window's
    fill on for the refine."""
    pipe = _run(6, every=1)
    rings = {r.name: r for r in profiling.collect().rings}
    assert rings["init_step"].stages == ["orb", "stereo", "map", "end"]
    assert rings["track_step"].stages == TRACK
    assert rings["refine_state"].stages == ["refine", "end"]
    W_ = pipe.cfg.window.window_frames
    assert [r.calls for r in (rings["init_step"], rings["track_step"], rings["refine_state"])] == [1, 5, 7 - W_]
    for r in rings.values():
        live = pipe.steps.rings[r.name]
        assert int(live.count) == live.calls == r.calls == len(r.stamps)
        steps = np.diff(r.stamps, axis=1)
        assert np.all(steps >= 0) and np.all(r.stamps[1:, 0] >= r.stamps[:-1, -1])
        assert np.array_equal(steps.sum(axis=1), r.stamps[:, -1] - r.stamps[:, 0])
        assert np.all(np.diff(r.host_ns) > 0)
    # frame t's track call comes after its init's or earlier track's end
    assert rings["track_step"].stamps[0, 0] >= rings["init_step"].stamps[0, -1]


def test_a_ring_wraps_at_its_depth_and_collect_keeps_the_newest_calls_in_order():
    ring = profiling.ring("track_step", "cpu")
    n = profiling.DEPTH + 5
    for i in range(n):
        ring.called()
        with profiling.stamping(ring):
            with profiling.stage("a"):
                pass
            with profiling.stage("b"):
                pass
    assert int(ring.count) == ring.calls == n
    (rec,) = profiling.collect().rings
    assert rec.stages == ["a", "b", "end"] and rec.stamps.shape == (profiling.DEPTH, 3) and rec.calls == n
    assert rec.host_ns[0] == ring.host_ns[5] and rec.host_ns[-1] == ring.host_ns[4]
    assert np.all(np.diff(rec.stamps[:, 0]) > 0) and np.all(np.diff(rec.host_ns) > 0)


def test_a_ring_refuses_stages_out_of_their_order_and_more_than_its_width():
    ring = profiling.ring("r", "cpu")
    with profiling.stamping(ring), profiling.stage("a"), profiling.stage("b"):
        pass
    with pytest.raises(ValueError, match="earlier calls had 'a'"):
        with profiling.stamping(ring), profiling.stage("b"):
            pass
    wide = profiling.ring("wide", "cpu")
    with pytest.raises(ValueError, match="more than"):
        with profiling.stamping(wide):
            for i in range(profiling.WIDTH + 1):
                with profiling.stage(f"s{i}"):
                    pass


def test_a_stage_without_a_current_ring_does_nothing():
    with profiling.stage("orb"):
        pass
    trace = profiling.collect()
    assert trace.rings == [] and trace.spans == []


def _ring(name, stamps, host_ns, stages=TRACK) -> RingRecord:
    stamps = np.asarray(stamps, np.int64)
    return RingRecord(name, list(stages), stamps, np.asarray(host_ns, np.int64), len(stamps))


def _trace(rings, spans=(), wrapped=False) -> Trace:
    return Trace(rings, list(spans), wrapped, 0, 0.0)


MS = 1_000_000


def test_per_iteration_readings_on_hand_made_stamps():
    """Three iterations of 10 ms on the host, each with one track call of
    stages 1..6 ms (21 ms a call) starting 30 ms apart on the device, and
    a refine of 4 ms after the second: the stage, step and outside-step
    means, and an iteration outside the given ones left out."""
    calls = [[t0 + MS * x for x in (0, 1, 3, 6, 10, 15, 21)] for t0 in (0, 30 * MS, 60 * MS, 90 * MS)]
    its = [(1000, 1000 + 10 * MS), (1000 + 10 * MS, 1000 + 20 * MS), (1000 + 20 * MS, 1000 + 30 * MS)]
    host = [a + 5 for a, _ in its] + [1000 + 99 * MS]   # the last call falls in no given iteration
    refine = _ring("refine_state", [[52 * MS, 56 * MS]], [its[1][0] + 7], stages=["refine", "end"])
    trace = _trace([_ring("track_step", calls, host), refine])
    for i, stage in enumerate(TRACK[:-1]):
        assert trace.stage_ms(its, stage) == pytest.approx(i + 1)
    assert trace.stage_ms(its, "refine") == pytest.approx(4 / 3)
    assert trace.stage_ms(its, "nothing") is None
    assert trace.step_ms(its) == pytest.approx(21 + 4 / 3)
    # from one iteration's first stamp to the next's (30 ms) less its calls
    assert trace.outside_step_ms(its) == pytest.approx(np.mean([30 - 21, 30 - 25]))
    assert sum(trace.stage_ms(its, s) for s in TRACK[:-1] + ["refine"]) == pytest.approx(trace.step_ms(its))
    assert trace.step_ms([]) is None and trace.outside_step_ms(its[:1]) is None


def test_readings_average_the_iterations_a_wrapped_ring_still_holds():
    its = [(k * 10 * MS, (k + 1) * 10 * MS) for k in range(10)]
    # the ring kept the calls of iterations 6-9 only
    calls = [[k * 10 * MS + x * MS for x in (0, 1, 2, 3, 4, 5, 7)] for k in range(6, 10)]
    trace = _trace([_ring("track_step", calls, [k * 10 * MS + 1 for k in range(6, 10)])])
    assert trace.step_ms(its) == pytest.approx(7.0) and trace.stage_ms(its, "map") == pytest.approx(2.0)


@pytest.mark.parametrize("offsets,want", [((0, 10, 20, 30), 40.0), ((0, 0, 0, 0), 10.0), ((0, 5, 10, 15), 25.0)])
def test_the_step_covers_the_union_of_the_streams_track_calls(offsets, want):
    """Four streams' 10 ms track calls in each of two steps 100 ms apart:
    one after another the step reads their sum, all at once one call,
    each starting halfway through the one before 25 ms; what lies outside
    it is the rest of the 100 ms."""
    its = [(0, 100 * MS), (100 * MS, 200 * MS)]
    rings = []
    for b, off in enumerate(offsets):
        starts = [s * 100 * MS + off * MS for s in range(2)]
        stamps = [[a + x * MS for x in (0, 2, 4, 6, 7, 8, 10)] for a in starts]
        rings.append(_ring("track_step", stamps, [s * 100 * MS + b + 1 for s in range(2)]))
    trace = _trace(rings)
    assert trace.step_ms(its) == pytest.approx(want)
    assert trace.outside_step_ms(its) == pytest.approx(100 - want)
    assert trace.stage_ms(its, "orb") == pytest.approx(8.0)


def test_stage_means_a_frame_from_a_wrapped_ring(monkeypatch):
    """Ten track calls whose stage ``a`` lasts c ms in call c, in a ring of
    depth 4, and three 4 ms refines: over ten frames ``a`` reads the mean of
    the calls held (6-9 ms) once a frame, ``refine`` 3 x 4 ms over 10."""
    monkeypatch.setattr(profiling, "DEPTH", 4)
    now = [0]
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=lambda: now[0]))
    track, refine = profiling.ring("track_step", "cpu"), profiling.ring("refine_state", "cpu")
    for c in range(10):
        with profiling.stamping(track):
            with profiling.stage("a"):
                now[0] += c * MS
            with profiling.stage("b"):
                now[0] += MS
    for _ in range(3):
        with profiling.stamping(refine), profiling.stage("refine"):
            now[0] += 4 * MS
    got = profiling.collect().stage_ms_per_frame(10)
    assert got == pytest.approx({"a": 7.5, "b": 1.0, "refine": 1.2})


def test_span_readings_and_the_iterations_a_wrapped_span_ring_holds():
    its = [(0, 10 * MS), (10 * MS, 20 * MS), (20 * MS, 30 * MS)]
    spans = [("pipeline.upload", 1 * MS, 3 * MS), ("pipeline.upload", 11 * MS, 12 * MS),
             ("pipeline.wait", 21 * MS, 25 * MS), ("pipeline.upload", 45 * MS, 46 * MS)]
    trace = _trace([], spans)
    assert trace.span_ms(its, "pipeline.upload") == pytest.approx(1.0)
    assert trace.span_ms(its, "pipeline.wait") == pytest.approx(4 / 3)
    assert trace.span_ms(its, "pipeline.append") is None
    # a full span ring counts only the iterations from its oldest record on
    assert _trace([], spans[1:], wrapped=True).span_ms(its, "pipeline.wait") == pytest.approx(4.0)


def test_iterations_convert_the_harness_seconds_and_stop_before_the_profiler():
    got = profiling.iterations([(2.0, 2.5), (1.0, 1.5), (3.0, 3.5)], before_s=3.2)
    assert got == [(1_000_000_000, 1_500_000_000), (2_000_000_000, 2_500_000_000)]
    assert len(profiling.iterations([(1.0, 1.5)])) == 1


def test_traced_copies_once_until_something_new_is_recorded(monkeypatch):
    copies = []
    collect = profiling.collect
    monkeypatch.setattr(profiling, "collect", lambda *a: copies.append(1) or collect(*a))
    with profiling.span("pipeline.upload"):
        pass
    its = [(1.0, 2.0)]
    assert profiling.traced() is profiling.traced() and len(copies) == 1
    assert profiling.reading(its, None, "span_ms", "pipeline.upload") is None and len(copies) == 1
    with profiling.span("pipeline.wait"):
        pass
    assert [s[0] for s in profiling.traced().spans] == ["pipeline.upload", "pipeline.wait"] and len(copies) == 2
    ring = profiling.ring("track_step", "cpu")
    profiling.traced()
    ring.called()
    with profiling.stamping(ring), profiling.stage("a"):
        pass
    assert len(profiling.traced().rings) == 1 and len(copies) == 4


def test_spans_keep_their_intervals_in_a_bounded_ring():
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    by = {s[0]: s for s in profiling.collect().spans}
    assert by["outer"][1] <= by["inner"][1] <= by["inner"][2] <= by["outer"][2]
    for i in range(profiling.SPANS_KEPT + 10):
        with profiling.span(f"many{i}"):
            pass
    trace = profiling.collect()
    assert len(trace.spans) == profiling.SPANS_KEPT and trace.spans_wrapped
    assert trace.spans[-1][0] == f"many{profiling.SPANS_KEPT + 9}"


def test_pipeline_spans_follow_each_frame():
    """Frame t's upload, dispatch and readback, then frame t-1's wait and
    append inside frame t's call (the last by ``flush()``), one after
    another on the host clock."""
    _run(4)
    spans = profiling.collect().spans
    frame = ["pipeline.upload", "pipeline.dispatch", "pipeline.readback"]
    done = ["pipeline.wait", "pipeline.append"]
    assert [s[0] for s in spans] == frame + 3 * (frame + done) + done
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_no_profiler_no_record_function(monkeypatch):
    """Spans and a whole pipeline frame never enter ``record_function``
    while no profiler runs."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.span("pipeline.upload"):
        pass
    _run(2)
    assert len(profiling.collect().spans) > 1


def test_under_a_cpu_profiler_the_spans_are_ranges_by_name():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("dp.state_copy"):
            with profiling.span("dp.stack"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"dp.state_copy", "dp.stack"} <= names
    assert [s[0] for s in profiling.collect().spans] == ["dp.stack", "dp.state_copy"]


def test_off_records_nothing():
    profiling.enable(False)
    assert profiling.ring("x", "cpu") is None
    with profiling.span("pipeline.upload"):
        pass
    profiling.count_capture(12.5)
    pipe = _run(3, traced=False)
    trace = profiling.collect()
    assert pipe.steps.rings == {} and trace.rings == [] and trace.spans == []
    assert trace.captures == 0 and trace.capture_ms == 0.0
    profiling.count_capture(12.5)
    profiling.count_capture(0.5)
    assert (profiling.collect().captures, profiling.collect().capture_ms) == (2, 13.0)


def test_dp_steps_span_and_stamp_each_stream():
    """Two streams, three steps on the CPU: each stream's init and track
    rings count its calls; a step spans each stream's upload and dispatch,
    then the state copy and the stack; the CPU runs the streams one after
    another, so the step covers the sum of their calls."""
    cfg = _cfg()
    step = make_dp_tracker(["cpu"], cfg)
    states = batched_init_state(cfg, 2, ["cpu"])
    src, nb = two_plane_frame_source(H, W), cfg.semantic.max_boxes
    its = []
    for s in range(3):
        frames = FrameInput(torch.stack([torch.from_numpy(src(s + 2 * b)[0]) for b in range(2)]),
                            torch.stack([torch.from_numpy(src(s + 2 * b)[1]) for b in range(2)]),
                            torch.zeros((2, nb, 4)), torch.zeros((2, nb), dtype=torch.bool))
        t0 = time.perf_counter_ns()
        states, _ = step(states, frames)
        its.append((t0, time.perf_counter_ns()))
    trace = profiling.collect()
    assert sorted((r.name, r.calls) for r in trace.rings) == [("init_step", 1)] * 2 + [("track_step", 2)] * 2
    one = 2 * ["dp.upload", "dp.dispatch"] + ["dp.state_copy", "dp.stack"]
    assert [s[0] for s in trace.spans] == 3 * one
    calls = sum(int(np.sum(r.stamps[:, -1] - r.stamps[:, 0])) for r in trace.rings)
    assert trace.step_ms(its) == pytest.approx(calls / 3 / 1e6)
