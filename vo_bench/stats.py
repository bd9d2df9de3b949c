"""The arithmetic of the end-to-end metrics and of the trace: percentiles
over every iteration, a rate over the whole window, the union of device
intervals, idle gaps and a span's self time."""

from __future__ import annotations

import numpy as np


def p95_ms(iteration_s: list[float]) -> float:
    """The 95th percentile, in ms, of every iteration's wall time (linear
    interpolation between order statistics): never a median of chunks."""
    if not iteration_s:
        raise ValueError("no iteration in the window")
    return float(np.percentile(np.asarray(iteration_s, np.float64), 95.0)) * 1e3


def frames_per_s(delivered_at: list[float], t_start: float, seconds: float, streams: int) -> float:
    """Frames whose pose reached the host inside [t_start, t_start +
    seconds], over all ``streams``, divided by the window's seconds.
    ``delivered_at`` holds the host time at which each iteration handed
    back one pose a stream."""
    t_end = t_start + seconds
    n = sum(1 for t in delivered_at if t_start <= t <= t_end)
    return streams * n / seconds


def rate_bins(delivered_at: list[float], t_start: float, seconds: float, width: float,
              streams: int) -> list[float]:
    """``frames_per_s`` of each ``width``-second slice of the window, in
    order (the last slice may be shorter): where in the window a run lost
    its rate."""
    n = max(1, int(np.ceil(seconds / width)))
    counts = [0] * n
    for t in delivered_at:
        if t_start <= t <= t_start + seconds:
            counts[min(n - 1, int((t - t_start) // width))] += 1
    return [streams * c / min(width, seconds - i * width) for i, c in enumerate(counts)]


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    out, at = [], t0
    for a, b in union(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def self_seconds(parents, children) -> float:
    """The summed length of the ``parents`` intervals less the part of
    them that the ``children`` intervals cover."""
    kids = union(children)
    total = 0.0
    for a, b in parents:
        covered = sum(max(0.0, min(b, d) - max(a, c)) for c, d in kids)
        total += (b - a) - covered
    return total
