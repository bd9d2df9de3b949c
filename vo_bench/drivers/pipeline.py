"""One camera stream through ``engine/pipeline.VOPipeline.process_frame``, as
``run.py`` drives it: a loop iteration hands the pipeline the next frame
(numpy images and offline boxes) and, inside the call, takes frame t-1's
pose on the host (the pipeline's deferred readback).

Set-up builds the pipeline on the device, with its trajectory files in a
temporary directory, and runs the traffic's warm-up frames: frame 0 (the
init graph captured), frame 1 (the track graph) and, with the window BA,
the first refines, so every graph of the cell is captured and replayed
before the window.  Frame 0 is the check's start.

A sampled frame keeps a copy of the pipeline's state before and after it
(on the device, queued behind the step).
"""

from __future__ import annotations

import torch

from vo_bench.check import Sample


def _copy(state) -> tuple:
    return tuple(x.clone() for x in state)


class Driver:
    def __init__(self, bench):
        self.b = bench
        self.streams = 1
        self.t = 0
        self.window_from = None
        self._kept = []  # (t, before or None, after)

    def setup(self) -> None:
        from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline

        b = self.b
        self.pipe = VOPipeline(b.port_config, device=b.device, out_dir=b.out_dir,
                               local_ba_every=b.pipeline["local_ba_every"])
        for i in range(int(b.traffic["warmup_frames"])):
            self._frame(keep=i == 0)

    def _frame(self, keep: bool) -> None:
        (f,) = self.b.frames.get(self.t)
        before = _copy(self.pipe.state) if keep and self.t > 0 else None
        self.pipe.process_frame(f.left, f.right, f.boxes, f.boxes_valid, f.timestamp)
        if keep:
            self._kept.append((self.t, before, _copy(self.pipe.state)))
        self.t += 1

    def instrument(self, spans) -> None:
        steps = self.pipe.steps
        for method in ("init", "track", "refine"):
            spans.wrap(steps, method, "step")
        spans.wrap(self.pipe, "process_frame", "driver")
        spans.wrap(self.pipe, "_finalize", "driver.wait")

    def iterate(self, sample: bool) -> None:
        if self.window_from is None:
            self.window_from = self.t
        self._frame(sample)

    def finish(self) -> None:
        self.pipe.flush()
        self.pipe.writer.close()
        self.window_to = self.t
        outs = self.pipe.outputs
        self.ok = torch.stack([o.pnp_ok for o in outs]).cpu().tolist() if outs else []
        self.poses = list(self.pipe.writer.poses)

    def outcome(self) -> tuple[int, int]:
        frames = range(self.window_from or 0, self.window_to)
        failed = sum(1 for t in frames if t >= len(self.poses) or t >= len(self.ok) or not self.ok[t])
        return len(frames), failed

    def _kind(self, t: int) -> str:
        """init or track, as the pipeline chose for frame t: a reseed after
        ``reinit_after_lost`` frames lost, counted as the pipeline counts
        them (frame f-1 is read back after frame f's dispatch)."""
        after, lost = self.pipe.reinit_after_lost, 0
        for f in range(t + 1):
            init = f == 0 or (after > 0 and lost >= after)
            if f == t:
                return "init" if init else "track"
            if init:
                lost = 0
            if f >= 1:
                lost = 0 if self.ok[f - 1] else lost + 1
        raise AssertionError

    def samples(self) -> list[Sample]:
        every, W = self.b.pipeline["local_ba_every"], self.b.vo["window"]["window_frames"]
        out = []
        for t, before, after in self._kept:
            refine = every > 0 and t % every == 0 and t + 1 >= W
            out.append(Sample(0, t, self._kind(t), refine, before, after, self.poses[t]))
        return out

    def release(self) -> None:
        self._kept = []
        del self.pipe
