"""Spans around the calls into the program's layers, and the profiled
sub-window of a traced run.

``Spans`` records (name, start, end) on the host clock over the whole
window; while a profile is open each span is also a
``torch.profiler.record_function`` range, so that the device trace can
label its idle gaps with what the host was doing.  ``Profile`` holds
``torch.profiler`` (CPU and CUDA activity) open over a fixed number of
loop iterations and reduces its trace to device intervals with their CUDA
streams, host ranges, and the host's CUDA runtime calls with the
correlation ids that tie each to the device work it launched.
Its first start in a process takes seconds, and once started the tracing
slows every later launch on the host, so host spans are read only from
the iterations before it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            if self.annotate:
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def of(self, name: str) -> list[tuple[float, float]]:
        return [(a, b) for n, a, b in self.items if n == name]

    def wrap(self, obj, method: str, name: str) -> None:
        """Record ``obj.method`` calls as spans ``name`` (an attribute of
        the instance shadows the class's method)."""
        fn = getattr(obj, method)

        def spanned(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)

        setattr(obj, method, spanned)


class Profile:
    """The device trace of ``iterations`` loop iterations."""

    def __init__(self, iterations: int):
        self.iterations = iterations
        self.prof = None
        self.started = None  # the host clock when the profiler was asked to start
        self.t0 = self.window_s = 0.0
        self.device: list[tuple[str, str, float, float]] = []  # (name, cat, start us, dur us)
        self.streams: list[tuple[int, int]] = []                # each device event's (stream, correlation id)
        self.ranges: list[tuple[str, float, float]] = []       # host record_function ranges (name, start us, dur us)
        self.launches: list[tuple[str, float, float, int]] = []  # host runtime calls (name, start us, dur us, correlation)
        self.frames = 0

    @staticmethod
    def _activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start(self) -> None:
        _sync()
        self.started = time.perf_counter()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, frames: int) -> None:
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.frames = frames
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        for e in events:
            if "dur" not in e:
                continue
            cat = e.get("cat")
            args = e.get("args", {})
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", ""), cat, float(e["ts"]), float(e["dur"])))
                self.streams.append((int(args.get("stream", -1)), int(args.get("correlation", -1))))
            elif cat == "user_annotation":
                self.ranges.append((e.get("name", ""), float(e["ts"]), float(e["dur"])))
            elif cat == "cuda_runtime":
                self.launches.append((e.get("name", ""), float(e["ts"]), float(e["dur"]),
                                      int(args.get("correlation", -1))))

    def device_intervals(self) -> list[tuple[float, float]]:
        return [(ts, ts + dur) for _, _, ts, dur in self.device]

    def kernels(self) -> list[tuple[str, float]]:
        """(name, dur us) of every kernel."""
        return [(n, dur) for n, cat, _, dur in self.device if cat == "kernel"]

    def kernel_intervals(self) -> list[tuple[int, float, float]]:
        """(stream, start us, end us) of every kernel."""
        return [(stream, ts, ts + dur) for (_, cat, ts, dur), (stream, _) in zip(self.device, self.streams)
                if cat == "kernel"]

    def streams_launched_in(self, span: str) -> set[int]:
        """The streams of the kernels that runtime calls made inside the host
        ranges ``span`` launched (a graph replay's kernels carry its
        launch's correlation id)."""
        inside = [(ts, ts + dur) for name, ts, dur in self.ranges if name == span]
        corr = {c for _, ts, _, c in self.launches if any(a <= ts <= b for a, b in inside)}
        return {stream for (_, cat, _, _), (stream, c) in zip(self.device, self.streams)
                if cat == "kernel" and c in corr}
