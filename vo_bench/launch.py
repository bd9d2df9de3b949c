"""The card's launch state, read from a small CUDA graph of the harness's
own.

On the H100 the kernels of a captured graph run at one of two speeds: a
graph of one-element adds replays at ~1.08 us a node when the process
first touches the card, at ~1.26 us a node after the program's set-up,
and at ~1.08 again from a moment 3 to 40 s later to the end of the
process.  The program's graphs move with it (the sparse track graph 15.8
against 13.2 ms).  A cell whose traffic gives ``launch_wait_s`` waits
after its set-up, idle, until the probe reads its first speed again, so
that the window measures the state the process stays in.  The wait is
not in ``setup_s``: it runs no work of the program, and its length (0 to
44 s) is the card's, so counted it swung the set-up's median by a third
between two sets of runs of one code.  Each run reports it apart, under
``setup_parts``.
"""

from __future__ import annotations

import time

import torch

# the probe reads fast within this share of its first reading (the two
# speeds lie 16% apart; readings of one speed spread by ~2%)
FAST_WITHIN = 0.08
NODES = 1000


class LaunchProbe:
    def __init__(self, device: torch.device):
        self.x = torch.zeros(256, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.x.add_(1.0)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(NODES):
                self.x.add_(1.0)
        torch.cuda.synchronize(device)
        self.first_ms = self.read(5)

    def read(self, replays: int = 3) -> float:
        """The fastest of ``replays`` replays of the probe graph, in ms."""
        best = float("inf")
        for _ in range(replays):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            self.graph.replay()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1))
        return best

    def wait_fast(self, limit_s: float, poll_s: float = 0.25) -> dict:
        """Wait, idle, until the probe reads its first speed or ``limit_s``
        has passed.  -> what the wait read."""
        t0 = time.perf_counter()
        now = self.read()
        while now > self.first_ms * (1 + FAST_WITHIN) and time.perf_counter() - t0 < limit_s:
            time.sleep(poll_s)
            now = self.read()
        return {"launch_wait_s": time.perf_counter() - t0, "probe_first_us": self.first_ms * 1e3 / NODES,
                "probe_us": now * 1e3 / NODES, "launch_fast": now <= self.first_ms * (1 + FAST_WITHIN)}
