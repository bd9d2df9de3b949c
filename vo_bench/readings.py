"""Shared arithmetic of the per-layer readers (``vo_bench/metrics/``) and the
traced run's ``device`` block and ``breakdown``.

Host spans are read from the iterations before the profiler started (it
slows the host from then on); device numbers come from the profiled
sub-window alone.  "A frame" of a
per-layer metric is one loop iteration: one frame of every stream.
"""

from __future__ import annotations

import subprocess
from collections import defaultdict

from vo_bench import roofline, stats


def _before_profile(ctx, intervals):
    p = ctx.profile
    if p is None or p.started is None:
        return intervals
    return [(a, b) for a, b in intervals if b < p.started]


def span_ms_per_iteration(ctx, name: str, minus: str | None = None) -> float | None:
    """Mean a loop iteration of the host time inside spans ``name`` (less
    the part inside spans ``minus``), in ms."""
    if ctx.spans is None:
        return None
    its = _before_profile(ctx, ctx.spans.of("iteration"))
    parents = _before_profile(ctx, ctx.spans.of(name))
    if not its or not parents:
        return None
    children = _before_profile(ctx, ctx.spans.of(minus)) if minus else []
    return stats.self_seconds(parents, children) / len(its) * 1e3


def mean_iteration_s(ctx) -> float | None:
    """The mean host seconds of a loop iteration before the profiler."""
    if ctx.spans is None:
        return None
    its = _before_profile(ctx, ctx.spans.of("iteration"))
    return sum(b - a for a, b in its) / len(its) if its else None


def detection_kernels(ctx) -> tuple[list, list] | None:
    """(intervals of the kernels on the detection stream, intervals of the
    kernels on every other stream) in the profiled frames; the detection
    stream is the one that the harness's ``detect`` spans launch on.  None
    where no detection ran."""
    if not traced(ctx):
        return None
    streams = ctx.profile.streams_launched_in("detect")
    if len(streams) != 1:
        return None
    (det,) = streams
    kernels = ctx.profile.kernel_intervals()
    return ([(a, b) for s, a, b in kernels if s == det], [(a, b) for s, a, b in kernels if s != det])


def busy_and_window(profile) -> tuple[float, float]:
    """(device busy seconds: the union of kernels, copies and fills on every
    stream, the sub-window's host seconds)."""
    return stats.union_length(profile.device_intervals()) / 1e6, profile.window_s


def traced(ctx) -> bool:
    """Whether the run has a profiled sub-window with device activity."""
    p = ctx.profile
    return p is not None and p.frames > 0 and bool(p.device)


def kernels_per_iteration(ctx) -> float | None:
    if not traced(ctx):
        return None
    return len(ctx.profile.kernels()) / ctx.profile.frames


def device_us(ctx, fragments) -> float:
    return sum(dur for name, dur in ctx.profile.kernels() if any(f in name for f in fragments))


def card_popc_per_s() -> float:
    """Popcounts a second at this card's top SM clock and SM count."""
    import torch

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    return roofline.popc_per_s(torch.cuda.get_device_properties(0).multi_processor_count, float(mhz))


def roofline_pct(ctx, kernels) -> float | None:
    """100 x the bound time of ``kernels``' work in the profiled frames over
    their device time there; None where none of them ran."""
    if not traced(ctx):
        return None
    p = ctx.profile
    spent = {k: device_us(ctx, roofline.FRAGMENTS[k]) for k in kernels}
    if sum(spent.values()) <= 0.0:
        return None
    bounds = roofline.frame_bounds(ctx.vo, ctx.pipeline["local_ba_every"], card_popc_per_s())
    kernels = [k for k in kernels if k in bounds and spent[k] > 0.0]
    if not kernels:
        return None
    frames = p.frames * ctx.streams
    return 100.0 * sum(bounds[k] for k in kernels) * frames / (sum(spent[k] for k in kernels) / 1e6)


def breakdown(profile, top: int = 10) -> dict:
    """The sub-window's longest-running device operations by name, and its
    longest idle gaps, each labelled by the innermost harness span open on
    the host at the gap's middle."""
    by_name: dict[str, float] = defaultdict(float)
    for name, _, _, dur in profile.device:
        by_name[name] += dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    starts = [ts for _, ts, _ in profile.ranges] + [ts for _, _, ts, _ in profile.device]
    ends = [ts + d for _, ts, d in profile.ranges] + [ts + d for _, _, ts, d in profile.device]
    if not starts:
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": []}
    t0, t1 = min(starts), max(ends)
    labelled = []
    for a, b in stats.gaps(profile.device_intervals(), t0, t1):
        mid = (a + b) / 2
        open_ = [(d, name) for name, ts, d in profile.ranges if ts <= mid <= ts + d]
        label = min(open_)[1] if open_ else "harness"
        labelled.append([label, (b - a) / 1e6])
    labelled.sort(key=lambda x: -x[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled[:top]}
