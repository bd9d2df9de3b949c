"""Profiling / timing instrumentation.

Port of ``stereo_semantic_vo_tpu.utils.profiling``.  The reference's only
instrumentation is std::chrono around Track plus a median/mean printout at
exit (main.cpp:176-208).  Here: a stage timer with the same summary
semantics, and ``device_trace``, a ``torch.profiler`` capture of the host
and the card written as a Chrome trace (the JAX package's scope captures a
``jax.profiler`` trace for XProf).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self) -> None:
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "n": int(arr.size),
                "median_s": float(np.median(arr)),
                "mean_s": float(arr.mean()),
                "p95_s": float(np.percentile(arr, 95)),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} n={s['n']:5d} median={s['median_s'] * 1e3:8.2f}ms "
                f"mean={s['mean_s'] * 1e3:8.2f}ms p95={s['p95_s'] * 1e3:8.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """``torch.profiler`` scope over the host and, where there is one, the
    card; the trace is written under ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format, readable by
    TensorBoard's profiler plugin and Perfetto).  A no-op for None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
