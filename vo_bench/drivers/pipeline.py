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
(on the device, queued behind the step) and of the boxes the step tracked
it with.

Where the configuration has a ``detector``, the pipeline runs the port's
``YoloDetector`` on the run's weights blob, one frame behind the tracker
(``VOPipeline(detector=..., async_detect=True)``, a detect graph on a side
stream), and is handed no boxes.  The detector's ``heads`` is wrapped so
that the driver holds the head maps of its last call: under graphs, the
captured graph's own head tensors, which every replay writes (held, the
capture does not reuse their memory).  A sampled frame t copies them on the
detection stream before frame t's replay overwrites them, so it keeps the
maps of frame t-1's detection, which made its boxes, and copies the boxes
from the step graphs' static frame after its step.  These are the port's
own attributes (``YoloDetector.heads``, ``VOPipeline._detect_call``,
``_det_stream``, ``steps.frame``): where one is gone, the run stops with
an error rather than copy on the wrong stream or read nothing.
"""

from __future__ import annotations

import numpy as np
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
        self.online = bench.detector is not None
        self._heads: list[torch.Tensor] = []   # the head maps of the detector's last call
        self._kept = []  # (t, before or None, after, (boxes, valid), heads of frame t-1's detection or None)

    def setup(self) -> None:
        from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline

        b = self.b
        detector = None
        if self.online:
            from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector

            d = b.detector
            if not d["async"]:
                raise ValueError("the pipeline driver runs detection one frame behind the tracker only")
            detector = YoloDetector(d["cfg_text"], weights_bytes=d["blob"], conf_threshold=d["conf_threshold"],
                                    nms_iou=d["nms_iou"], max_boxes=d["max_boxes"], device=b.device)
            heads = detector.heads

            def kept_heads(img):
                out = heads(img)
                self._heads = [feat for _, feat in out]
                return out

            detector.heads = kept_heads
        self.pipe = VOPipeline(b.port_config, device=b.device, out_dir=b.out_dir,
                               local_ba_every=b.pipeline["local_ba_every"], detector=detector, async_detect=True)
        for i in range(int(b.traffic["warmup_frames"])):
            self._frame(keep=i == 0)

    def _detection_heads(self) -> tuple:
        """A copy of the head maps of the last detection, queued on the
        detection stream behind it and ahead of the next."""
        if not self._heads:
            raise RuntimeError("the detector's heads were never called: the pipeline's detection no longer goes "
                               "through YoloDetector.heads, so the check has no head maps")
        if self.b.device.type != "cuda":
            return tuple(h.clone() for h in self._heads)
        stream = getattr(self.pipe, "_det_stream", None)
        if not isinstance(stream, torch.cuda.Stream):
            raise RuntimeError("VOPipeline has no detection stream (_det_stream): the copy of the head maps "
                               "could not be queued between two detections")
        with torch.cuda.stream(stream):
            return tuple(h.clone() for h in self._heads)

    def _frame(self, keep: bool) -> None:
        (f,) = self.b.frames.get(self.t)
        before = _copy(self.pipe.state) if keep and self.t > 0 else None
        heads = self._detection_heads() if keep and self.online and self.t > 0 else None
        if self.online:
            self.pipe.process_frame(f.left, f.right, None, None, f.timestamp)
        else:
            self.pipe.process_frame(f.left, f.right, f.boxes, f.boxes_valid, f.timestamp)
        if keep:
            if self.online:
                used = self.pipe.steps.frame
                boxes = (used.boxes.clone(), used.boxes_valid.clone())
            else:
                boxes = (f.boxes.copy(), f.boxes_valid.copy())
            self._kept.append((self.t, before, _copy(self.pipe.state), boxes, heads))
        self.t += 1

    def instrument(self, spans) -> None:
        steps = self.pipe.steps
        for method in ("init", "track", "refine"):
            spans.wrap(steps, method, "step")
        spans.wrap(self.pipe, "process_frame", "driver")
        spans.wrap(self.pipe, "_finalize", "driver.wait")
        if self.online:
            spans.wrap(self.pipe, "_detect_call", "detect")

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
        if self.b.device.type == "cuda":
            torch.cuda.synchronize(self.b.device)   # the head copies ran on the detection stream
        every, W = self.b.pipeline["local_ba_every"], self.b.vo["window"]["window_frames"]
        out = []
        for t, before, after, (boxes, valid), heads in self._kept:
            refine = every > 0 and t % every == 0 and t + 1 >= W
            out.append(Sample(0, t, self._kind(t), refine, before, after, self.poses[t],
                              np.asarray(torch.as_tensor(boxes).cpu()), np.asarray(torch.as_tensor(valid).cpu()),
                              None if heads is None else t - 1,
                              None if heads is None else tuple(h.cpu().numpy() for h in heads)))
        return out

    def release(self) -> None:
        self._kept = []
        del self.pipe
