"""B camera streams on one card through ``parallel/dp_tracker``: a loop
iteration is one call of ``make_dp_tracker([device], cfg)``'s ``step`` on
the streams' frames stacked on a leading axis, uploaded from pinned
memory without blocking.  Each step's ``pnp_ok`` and ``T_wc`` are copied
to pinned memory behind an event on the device, and the harness waits on
that event only after the next step is queued: the host never waits on
the step it just handed over.

Set-up builds the tracker, runs the traffic's warm-up steps (every
stream's init graph at step 0, its track graph at step 1), and keeps step
0 as the check's start.  The states a step hands out are copies the
tracker makes on the device, so a sampled step keeps the states before and
after it as they are.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vo_bench.check import Sample


class Driver:
    def __init__(self, bench):
        self.b = bench
        self.streams = int(bench.traffic["streams"])
        self.s = 0
        self.window_from = None
        self._kept = []     # (step, states before or None, states after, (boxes, valid) as handed over)
        self.host = []      # per step: (pnp_ok (B,), T_wc (B, 4, 4)) on the host
        self._pending = None
        self._span = lambda name: contextlib.nullcontext()

    def setup(self) -> None:
        from stereo_semantic_vo_tpu_torch.parallel.dp_tracker import batched_init_state, make_dp_tracker

        b, B = self.b, self.streams
        dev = b.device
        self.cuda = dev.type == "cuda"
        self.step = make_dp_tracker([dev], b.port_config)
        self.states = batched_init_state(b.port_config, B, [dev])
        cam, nb = b.vo["camera"], b.vo["semantic"]["max_boxes"]
        H, W = cam["height"], cam["width"]

        def pinned(shape, dtype):
            t = torch.empty(shape, dtype=dtype)
            return t.pin_memory() if self.cuda else t

        # two staging buffers for the stacked frames, two readback slots
        self._stage = [(pinned((B, H, W), torch.float32), pinned((B, H, W), torch.float32),
                        pinned((B, nb, 4), torch.float32), pinned((B, nb), torch.bool)) for _ in range(2)]
        self._staged = [None, None]  # the event after each buffer's upload
        self._slots = [(pinned((B,), torch.bool), pinned((B, 4, 4), torch.float32)) for _ in range(2)]
        for i in range(int(b.traffic["warmup_frames"])):
            self._step(keep=i == 0)

    def _upload(self):
        """Step s's frames, made into a pinned staging buffer and copied to
        the device without blocking."""
        from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput

        k = self.s % 2
        if self._staged[k] is not None:
            self._staged[k].synchronize()  # the upload two steps back has read this buffer
        left, right, boxes, valid = self._stage[k]
        out = [(left[i].numpy(), right[i].numpy()) for i in range(self.streams)]
        for i, f in enumerate(self.b.frames.get(self.s, out)):
            boxes[i].numpy()[...] = f.boxes
            valid[i].numpy()[...] = f.boxes_valid
        dev = self.b.device
        out = FrameInput(*(x.to(dev, non_blocking=True) for x in (left, right, boxes, valid)))
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self._staged[k] = ev
        return out

    def _step(self, keep: bool) -> None:
        before = self.states if self.s > 0 else None
        inputs = self._upload()
        handed = tuple(x.numpy().copy() for x in self._stage[self.s % 2][2:]) if keep else None
        with self._span("dp"):
            new, out = self.step(self.states, inputs)
        ok, T_wc = self._slots[self.s % 2]
        ok.copy_(out.pnp_ok, non_blocking=True)
        T_wc.copy_(out.T_wc, non_blocking=True)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.b.device))
        with self._span("dp"):
            self._take_pending()
        self._pending = (ok, T_wc, done)
        if keep:
            self._kept.append((self.s, before, new, handed))
        self.states = new
        self.s += 1

    def _take_pending(self) -> None:
        """Wait for the previous step's readback and keep its poses."""
        if self._pending is None:
            return
        ok, T_wc, done = self._pending
        if done is not None:
            done.synchronize()
        self.host.append((ok.numpy().copy(), T_wc.numpy().astype(np.float64)))
        self._pending = None

    @property
    def t(self) -> int:
        """The frame index that the next step hands over (stream b's frame
        in its own world, offset by the scene)."""
        return self.s

    def instrument(self, spans) -> None:
        for sg in self.step.steps.values():
            for method in ("init", "track"):
                spans.wrap(sg, method, "step")
        self._span = spans

    def iterate(self, sample: bool) -> None:
        if self.window_from is None:
            self.window_from = self.s
        self._step(sample)

    def finish(self) -> None:
        self._take_pending()
        self.window_to = self.s

    def outcome(self) -> tuple[int, int]:
        steps = range(self.window_from or 0, self.window_to)
        failed = 0
        for s in steps:
            if s >= len(self.host):
                failed += self.streams
            else:
                failed += int((~self.host[s][0]).sum())
        return len(steps) * self.streams, failed

    def samples(self) -> list[Sample]:
        out = []
        for s, before, after, (boxes, valid) in self._kept:
            for b in range(self.streams):
                out.append(Sample(b, s, "init" if s == 0 else "track", False,
                                  None if before is None else tuple(before[b]), tuple(after[b]),
                                  self.host[s][1][b], boxes[b], valid[b]))
        return out

    def release(self) -> None:
        self._kept = []
        del self.step, self.states
