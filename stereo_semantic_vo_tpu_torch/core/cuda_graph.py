"""CUDA graphs: the port's counterpart of the reference's ``jax.jit``.

A :class:`Graph` is one function of fixed buffers.  Its first call runs the
function eagerly on its capture stream and returns that result: the
warm-up, which builds the kernel library and uploads the cached constants,
and creates the libraries' handles and workspaces, none of which a capture
may do.  It then captures the function into a CUDA graph in a memory pool;
every later call replays the graph and returns the captured outputs, which
the next replay overwrites.  Graphs that share a pool must run one after
another, never at once.  A pool (:func:`capture_pool`) comes with a
capture stream of its own, so graphs that may run at once (the streams of
the dp tracker, detection beside the step, the trainer beside a pipeline,
the devices of the replicated detector) hold separate pools and so
separate streams as well: the libraries key their workspaces (cuBLAS's)
by the stream a call is made on, and a captured kernel keeps the
workspace of its capture stream, so two graphs captured on one stream
would share it at every replay.  A capture or a replay that fails raises:
nothing falls back to eager dispatch on a card.  A graph may hold NCCL
collectives (the sharded refine's all-reduces and all-gather): the
warm-up runs them eagerly first, which creates the communicator outside
the capture.

The kernels' launch counters (``kernels.launch_counters``) count in the
wrappers, which run only during a capture: a graph records each counter's
rise during its capture, puts the counter back, and adds that rise on every
replay, so the counts stay those of the kernels that ran.  The tracer
(utils/profiling.py) counts every capture and its milliseconds.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, NamedTuple

import torch

from stereo_semantic_vo_tpu_torch.kernels import launch_counters
from stereo_semantic_vo_tpu_torch.utils import profiling


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _tensors(item)]
    return []


class CapturePool(NamedTuple):
    """A graph memory pool and the stream its graphs are captured on."""

    handle: tuple
    stream: torch.cuda.Stream


def capture_pool(device: torch.device) -> CapturePool:
    """A new pool on ``device`` with a capture stream of its own."""
    with torch.cuda.device(device):
        return CapturePool(torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))


class Graph:
    """``fn()``, a function of fixed buffers on ``device``, run eagerly once
    on ``pool``'s stream and then replayed from a CUDA graph captured
    there into ``pool``."""

    def __init__(self, fn: Callable, pool: CapturePool, device: torch.device):
        self.fn, self.pool, self.device = fn, pool, device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.rise: list[tuple[Callable, int]] = []  # (counted kernel entry, launches a replay)
        self.capture_ms = 0.0
        self.pool_bytes = 0  # the device memory the capture reserved
        self.replays = 0

    def __call__(self):
        with torch.cuda.device(self.device):
            if self.graph is None:
                out = self._warm_up()
                self._capture()
                return out
            self.graph.replay()
        self.replays += 1
        for entry, n in self.rise:
            entry.launches += n
        return self.outputs

    def _warm_up(self):
        cur = torch.cuda.current_stream()
        # on the capture stream, so that the libraries create its
        # workspaces now and not inside the capture
        side = self.pool.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        for x in _tensors(out):
            x.record_stream(cur)
        return out

    def _capture(self) -> None:
        entries = list(launch_counters().values())
        before = [e.launches for e in entries]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph collects garbage before the capture begins; no
        # collection may run inside it, where freeing another CUDA graph or
        # event would make a call the capture forbids and invalidate it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle, stream=self.pool.stream):
                self.outputs = self.fn()
        finally:  # nothing ran during the capture
            if collecting:
                gc.enable()
            rise = [(e, e.launches - b) for e, b in zip(entries, before) if e.launches != b]
            for e, b in zip(entries, before):
                e.launches = b
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        profiling.count_capture(self.capture_ms)
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.rise, self.graph = rise, graph
