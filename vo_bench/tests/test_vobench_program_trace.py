"""The readers of the program's own tracer (``stereo_semantic_vo_tpu_torch.
utils.profiling``) on a hand-made tracer state and run context: the stage,
step and outside-step device times (the union of the streams' replays in the
fleet), the program spans' host times and the graphs' capture milliseconds,
each over the iterations before the profiler, from one copy of the records;
and, for a program without the tracer (the benchmark's
files laid over an older checkout), every one of them reads nothing and
raises nothing."""

import os
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu_torch.utils import profiling
from vo_bench import bench
from vo_bench.trace import Spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MS = 1_000_000
BASE_S = 1000.0   # the harness clock at the first iteration
STAGES = ["orb", "stereo", "match", "pnp", "lm", "map"]
STREAM1 = [f"ops.{s}.device_ms" for s in STAGES] + [
    "step.device_ms", "device.outside_step_ms", "driver.upload_ms", "driver.event_wait_ms", "driver.append_ms",
    "setup.capture_ms"]
NEW = STREAM1 + ["ops.refine.device_ms", "step.device_ms.fleet"]


def readers(cell: str) -> dict:
    return {m["name"]: mod for m, mod in bench.find_cell(cell, ROOT).per_layer}


@pytest.fixture(autouse=True)
def tracer():
    profiling.clear()
    profiling.enable(True)
    yield
    profiling.clear()


def _ctx(n_its: int, profiled_from: int | None):
    """A run of ``n_its`` 10 ms iterations on the harness clock, the
    profiler started at iteration ``profiled_from``."""
    spans = Spans()
    for k in range(n_its):
        spans.items.append(("iteration", BASE_S + 0.01 * k, BASE_S + 0.01 * k + 0.009))
    profile = None if profiled_from is None else SimpleNamespace(started=BASE_S + 0.01 * profiled_from - 0.0005)
    return SimpleNamespace(spans=spans, profile=profile, streams=1, iterations=n_its)


def _host_ns(k: int, at_ms: float) -> int:
    return int((BASE_S + 0.01 * k) * 1e9) + int(at_ms * MS)


def _ring(name: str, stages: list[str], rows: list[list[int]], host_ns: list[int]):
    r = profiling.ring(name, "cpu")
    r.stages = stages + ["end"]
    r.stamps[:len(rows), :len(r.stages)] = torch.tensor(rows, dtype=torch.int64)
    r.count.fill_(len(rows))
    r.calls = len(rows)
    r.host_ns[:len(rows)] = host_ns
    return r


def _span(name: str, k: int, start_ms: float, ms: float) -> None:
    profiling._TRACER.spans.append((name, _host_ns(k, start_ms), _host_ns(k, start_ms) + int(ms * MS)))


def _stream1(profiled_last_ms: float = 100.0) -> SimpleNamespace:
    """Four iterations, the last profiled: a track call a frame with stages
    of 1..6 ms, 30 ms apart on the device, and a 4 ms refine after it; the
    program's upload 2 ms, wait 3 ms and append 0.5 ms an iteration.  The
    profiled iteration's calls and spans are ``profiled_last_ms`` long."""
    track, refine = [], []
    for k in range(4):
        scale = profiled_last_ms if k == 3 else 1.0
        t0 = k * 30 * MS
        track.append([t0 + int(scale * MS * x) for x in (0, 1, 3, 6, 10, 15, 21)])
        refine.append([t0 + int(scale * 21 * MS), t0 + int(scale * 25 * MS)])
        _span("pipeline.upload", k, 0.1, 2.0 * scale)
        _span("pipeline.wait", k, 3.0, 3.0 * scale)
        _span("pipeline.append", k, 6.5, 0.5 * scale)
    _ring("track_step", STAGES, track, [_host_ns(k, 2.5) for k in range(4)])
    _ring("refine_state", ["refine"], refine, [_host_ns(k, 2.7) for k in range(4)])
    profiling.count_capture(120.0)
    profiling.count_capture(30.5)
    return _ctx(4, profiled_from=3)


@pytest.mark.parametrize("cell", ["sparse.stream1", "dense_ba.stream1"])
def test_stream1_readers_on_a_hand_made_run(cell):
    ctx = _stream1()
    got = {name: mod.read(ctx) for name, mod in readers(cell).items() if name in NEW}
    want = {f"ops.{s}.device_ms": float(i + 1) for i, s in enumerate(STAGES)}
    want.update({"step.device_ms": 25.0, "device.outside_step_ms": 5.0, "driver.upload_ms": 2.0,
                 "driver.event_wait_ms": 3.0, "driver.append_ms": 0.5, "setup.capture_ms": 150.5})
    if cell.startswith("dense"):
        want["ops.refine.device_ms"] = 4.0
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == pytest.approx(value), name
    # the stages tile the step; the step and what lies outside it the period
    ops = sum(got[n] for n in got if n.startswith("ops."))
    assert ops == pytest.approx(got["step.device_ms"] - (0.0 if "ops.refine.device_ms" in got else 4.0))
    assert got["step.device_ms"] + got["device.outside_step_ms"] == pytest.approx(30.0)


def test_a_run_whose_profiler_never_started_reads_every_iteration():
    ctx = _stream1(profiled_last_ms=1.0)
    ctx.profile = None
    r = readers("sparse.stream1")
    assert r["step.device_ms"].read(ctx) == pytest.approx(21.0 + 4.0)
    assert r["driver.upload_ms"].read(ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("offsets,want", [((0, 0, 0, 0), 10.0), ((0, 10, 20, 30), 40.0), ((0, 5, 10, 15), 25.0)])
def test_the_fleet_readers_on_hand_made_streams(offsets, want):
    """Four streams' 10 ms track calls in each of three steps, the third
    profiled: ``step.device_ms.fleet`` (read with ``step.device_ms.py``) is
    the union of the streams' calls, the device time the step's replays
    cover."""
    for b, off in enumerate(offsets):
        rows = [[s * 100 * MS + off * MS + x * MS for x in (0, 1, 2, 3, 4, 5, 10)] for s in range(3)]
        _ring("track_step", STAGES, rows, [_host_ns(s, 1.0 + b) for s in range(3)])
    ctx = _ctx(3, profiled_from=2)
    r = readers("sparse.fleet4")
    assert r["step.device_ms.fleet"].__file__.endswith("step.device_ms.py")
    assert r["step.device_ms.fleet"].read(ctx) == pytest.approx(want)
    assert r["setup.capture_ms"].read(ctx) is None   # no capture counted


def test_the_readers_share_one_copy_of_the_records(monkeypatch):
    """Every reader of a cell reads the one copy that the first made."""
    ctx = _stream1()
    copies = []
    collect = profiling.collect
    monkeypatch.setattr(profiling, "collect", lambda *a: copies.append(1) or collect(*a))
    got = [mod.read(ctx) for name, mod in readers("dense_ba.stream1").items() if name in NEW]
    assert len(got) == len(STREAM1) + 1 and None not in got and len(copies) == 1


def test_without_spans_or_records_the_readers_read_nothing():
    ctx = _ctx(3, None)
    for cell in ("sparse.stream1", "dense_ba.stream1", "sparse.fleet4"):
        for name, mod in readers(cell).items():
            if name in NEW:
                assert mod.read(ctx) is None, name
                assert mod.read(SimpleNamespace(spans=None, profile=None)) is None, name


def test_a_program_without_the_tracer_reads_nothing_and_raises_nothing(monkeypatch):
    """The parent's checkout has ``utils/profiling`` without the tracer:
    every new reader returns None there."""
    ctx = _stream1()
    monkeypatch.setitem(sys.modules, "stereo_semantic_vo_tpu_torch.utils.profiling",
                        types.ModuleType("stereo_semantic_vo_tpu_torch.utils.profiling"))
    for cell in ("sparse.stream1", "dense_ba.stream1", "sparse.fleet4"):
        for name, mod in readers(cell).items():
            if name in NEW:
                assert mod.read(ctx) is None, name


def test_the_new_entries_are_appended_and_each_has_its_reader():
    b = bench.benchmark(ROOT)
    names = [m["name"] for m in b["per_layer"]]
    first = names.index("ops.orb.device_ms")
    block = b["per_layer"][first:first + len(NEW)]
    assert names[first:first + len(NEW)] == [*(f"ops.{s}.device_ms" for s in STAGES), "ops.refine.device_ms", "step.device_ms",
                                 "step.device_ms.fleet", "device.outside_step_ms",
                                 "driver.upload_ms", "driver.event_wait_ms", "driver.append_ms",
                                 "setup.capture_ms"]
    here = os.path.join(ROOT, "vo_bench")
    for m in block:
        assert os.path.isfile(bench.reader_path(here, m)), m["name"]
    got = {m["name"]: set(m["workloads"]) for m in block}
    assert got["setup.capture_ms"] == {"sparse.stream1", "dense_ba.stream1", "sparse.fleet4", "online.stream1"}
    assert got["ops.refine.device_ms"] == {"dense_ba.stream1"} and got["step.device_ms.fleet"] == {"sparse.fleet4"}
    assert np.all([got[n] == {"sparse.stream1", "dense_ba.stream1", "online.stream1"}
                   for n in STREAM1 if n != "setup.capture_ms"])
