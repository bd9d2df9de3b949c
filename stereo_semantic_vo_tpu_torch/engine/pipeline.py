"""Sequence driver: load frames, obtain detection boxes (offline files or
the online YOLO detector), run the tracking step, write trajectories, report
per-frame times.

Port of ``stereo_semantic_vo_tpu.engine.pipeline.VOPipeline``.  With
``local_ba_every=N`` the window BA (engine/window_ba.py) refines the state
every N-th frame once the window is full; with a ``ba_mesh``
(parallel/mesh.py) it is the landmark-sharded ``WindowBA``: every rank runs
a pipeline on its own device over the same frames, and the refine's solve
is split over the ranks; on a card its refine graph holds the mesh's
collectives.  Frame decode runs on a prefetch thread; frames
are copied to the device from pinned memory without blocking.  The
readback is deferred by one frame: at the end of frame t's dispatch, on
the main stream after its last step, ``pnp_ok`` and ``T_wc`` are copied
into one of two pinned host slots without blocking and an event is
recorded; after dispatching frame t+1 the host waits on frame t's event
alone and reads the slot.  So the host never waits on the step it just
queued, and prepares frame t+1 while the device runs frame t.

On a card each frame replays CUDA graphs (engine/graphs.py), the port's
counterpart of the reference's jitted step: ``init_step`` or
``track_step`` (chosen on the host, as the reference's pipeline does), the
window refine on refine frames (sharded over the mesh, NCCL included,
with a ``ba_mesh``) and, online, ``detect``.  The first call of
each runs eagerly and captures it.  Frames are uploaded straight into the
graphs' static buffers, and the outputs that ``_finalize`` and ``outputs``
keep are copied on the device before the next replay overwrites them.
``capture=False`` switches the graphs off (the counterpart of
``jax.disable_jit``, for debugging and for reading eager against graph);
the CPU runs the eager functions.

With a ``detector`` (models/yolo.YoloDetector on the pipeline's device) and
``async_detect=True``, frame t tracks with frame t-1's detections and frame
0 with none: the one-frame staleness of the reference's detector thread
(src/semantic.cc).  On a card, detection of frame t is queued on a side CUDA
stream as soon as left(t) is uploaded, ahead of ``track_step(t)``, whose
kernels never wait for it; frame t+1's step makes the main stream wait on
the event detection recorded before it reads the boxes (and, under graphs,
before the next frame's upload overwrites the image detection reads).  The host waits on neither.  On the CPU the same calls run in order.  With
``async_detect=False`` each frame is detected, read back and tracked with
its own boxes, as the reference does.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Iterable

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.core.cuda_graph import Graph, capture_pool
from stereo_semantic_vo_tpu_torch.engine.graphs import StepGraphs
from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs, init_state
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput
from stereo_semantic_vo_tpu_torch.engine.window_ba import WindowBA
from stereo_semantic_vo_tpu_torch.engine.trajectory import TrajectoryWriter
from stereo_semantic_vo_tpu_torch.utils import profiling


def _prefetch(iterator: Iterable, depth: int = 2):
    """Run an iterator in a daemon thread with a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item


class VOPipeline:
    def __init__(
        self,
        cfg: VOConfig,
        device: torch.device | str = "cuda",
        detector: Any | None = None,
        out_dir: str | None = None,
        write_trajectory: bool = True,
        local_ba_every: int = 0,
        ba_mesh=None,
        reinit_after_lost: int = 3,
        async_detect: bool = True,
        capture: bool | None = None,
    ):
        self.cfg = cfg
        self.local_ba_every = local_ba_every
        self.device = torch.device(device)
        if capture is None:
            capture = self.device.type == "cuda"
        state = init_state(cfg, self.device)
        self.window_ba = None
        if local_ba_every > 0 and ba_mesh is not None:
            if ba_mesh.device != state.T_cw.device:
                raise ValueError(f"the mesh's rank runs on {ba_mesh.device}, the pipeline on {state.T_cw.device}")
            self.window_ba = WindowBA(cfg, mesh=ba_mesh)
        self.steps = StepGraphs(cfg, state, capture, self.window_ba)
        self.detector = detector
        if detector is not None and detector.device != self.steps.device:
            raise ValueError(f"the detector runs on {detector.device}, the pipeline on {self.steps.device}")
        self.async_detect = async_detect
        # frame t's detections (max_boxes, 4) / (max_boxes,), used by frame t+1
        self._det_pending: tuple[torch.Tensor, torch.Tensor] | None = None
        self._det_done: torch.cuda.Event | None = None
        self._det_stream = (
            torch.cuda.Stream(self.device)
            if detector is not None and async_detect and self.device.type == "cuda"
            else None
        )
        # detect(left / 255) of the static left image, cut or padded to
        # max_boxes; a pool of its own, since on the side stream it runs
        # beside the step's graphs
        self._det_graph = (
            Graph(lambda: self._detections(self.steps.frame.left), capture_pool(self.device), self.device)
            if detector is not None and capture else None
        )
        # tracking-lost recovery: reseed the map after N consecutive PnP
        # failures (0 disables)
        self.reinit_after_lost = reinit_after_lost
        self._consecutive_lost = 0
        self.n_reinits = 0
        kitti_path = tum_path = None
        if write_trajectory and out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            kitti_path = os.path.join(out_dir, "cameratrajectory_kitti.txt")
            tum_path = os.path.join(out_dir, "cameratrajectory_tum.txt")
        self.writer = TrajectoryWriter(kitti_path, tum_path)
        self.frame_times: list[float] = []
        self.outputs: list[Any] = []
        # (device outputs, timestamp, what _finalize reads: (pnp_ok, T_wc, event))
        self._pending: tuple[Any, float, tuple] | None = None
        self._n_processed = 0
        # two pinned slots for (pnp_ok, T_wc): frame t writes slot t % 2
        # while _finalize reads frame t-1's
        self._host_slots = [
            (torch.zeros((), dtype=torch.bool).pin_memory(), torch.zeros((4, 4), dtype=torch.float32).pin_memory())
            for _ in range(2)] if self.device.type == "cuda" else None

    @property
    def state(self):
        """The tracker's current ``VOState`` (under graphs, the static
        state that the next replay updates in place)."""
        return self.steps.state

    def resume(self, state) -> None:
        """Continue a sequence from ``state`` (utils/checkpoint.load_state
        on this pipeline's device): the next frame is ``state.frame_idx +
        1`` and tracks against its map.  Reads the frame counter once."""
        self.steps.load_state(state)
        self._n_processed = int(state.frame_idx) + 1

    def _to_device(self, a: np.ndarray, out: torch.Tensor | None = None) -> torch.Tensor:
        """Host array -> this pipeline's device, from pinned memory without
        blocking on a card; into ``out`` (a static buffer) where given."""
        t = torch.from_numpy(np.array(a))  # a writable copy: callers may pass read-only views
        if self.device.type != "cuda":
            return t.to(self.device)
        if out is None:
            return t.pin_memory().to(self.device, non_blocking=True)
        if t.shape != out.shape or t.dtype != out.dtype:
            raise ValueError(f"a {t.dtype} array of shape {tuple(t.shape)} for a static buffer of {out.dtype} "
                             f"{tuple(out.shape)}")
        return out.copy_(t.pin_memory(), non_blocking=True)

    def _fit_boxes(self, boxes: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Cut or zero-pad detections to ``cfg.semantic.max_boxes``."""
        nb, n = self.cfg.semantic.max_boxes, boxes.shape[0]
        if n >= nb:
            return boxes[:nb], valid[:nb]
        return (torch.cat([boxes, boxes.new_zeros((nb - n, 4))]),
                torch.cat([valid, valid.new_zeros((nb - n,))]))

    def _detections(self, left: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        det = self.detector.detect(left / 255.0)
        return self._fit_boxes(det.boxes, det.valid)

    def _detect_call(self, left: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This frame's detections: a replay of the detect graph (which
        reads the static left image) or the eager call."""
        if self._det_graph is not None:
            return self._det_graph()
        return self._detections(left)

    def _detect(self, left: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """Detect on this frame and read the boxes back, as the reference's
        synchronous mode does."""
        return tuple(x.cpu().numpy() for x in self._detect_call(left))

    def _detect_async(self, left: torch.Tensor) -> None:
        """Queue detection of this frame; the next frame consumes it."""
        stream = self._det_stream
        if stream is None:
            self._det_pending = self._detect_call(left)
            return
        stream.wait_stream(torch.cuda.current_stream(self.device))  # left's upload
        with torch.cuda.stream(stream):
            self._det_pending = self._detect_call(left)
            self._det_done = torch.cuda.Event()
            self._det_done.record(stream)
        left.record_stream(stream)

    def _stale_boxes(self, frame: FrameInput | None) -> tuple[torch.Tensor, torch.Tensor]:
        """The previous frame's detections (none on the first frame), ready
        for the main stream once it has waited on their event; copied into
        the static ``frame`` buffers under graphs, since the next detect
        replay overwrites its outputs."""
        nb = self.cfg.semantic.max_boxes
        if self._det_pending is None:
            if frame is not None:
                return frame.boxes.zero_(), frame.boxes_valid.zero_()
            return (torch.zeros((nb, 4), dtype=torch.float32, device=self.device),
                    torch.zeros((nb,), dtype=torch.bool, device=self.device))
        boxes, valid = self._det_pending
        if self._det_done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(self._det_done)
            if frame is None:
                boxes.record_stream(main)
                valid.record_stream(main)
        if frame is not None:
            return frame.boxes.copy_(boxes), frame.boxes_valid.copy_(valid)
        return boxes, valid

    def process_frame(
        self,
        left: np.ndarray,
        right: np.ndarray,
        boxes: np.ndarray | None,
        boxes_valid: np.ndarray | None,
        timestamp: float,
    ):
        """Track one stereo pair.  ``boxes`` None means: detect with the
        pipeline's detector, or no boxes without one.

        Its program spans (utils/profiling.span): ``pipeline.upload``
        (images and boxes into the static buffers, and online the queued
        detection), ``pipeline.dispatch`` (the replays),
        ``pipeline.readback`` (the output clones and the queued copy to the
        host), then, in ``_finalize`` of frame t-1, ``pipeline.wait`` (the
        wait on its readback event alone) and ``pipeline.append`` (the
        trajectory writer's append)."""
        t0 = time.perf_counter()
        steps = self.steps
        with profiling.span("pipeline.upload"):
            left = np.asarray(left, np.float32)
            nb = self.cfg.semantic.max_boxes if boxes is None else len(boxes)
            static = steps.frame_buffers(left.shape, nb) if steps.capture else None
            dst = static._asdict() if static is not None else {}  # the uploads' static buffers
            online = boxes is None and self.detector is not None and self.async_detect
            if online:
                # before the upload: under graphs the detection of the frame
                # before reads the static left image
                boxes_dev, valid_dev = self._stale_boxes(static)
            left_dev = self._to_device(left, dst.get("left"))
            if online:
                self._detect_async(left_dev)
            else:
                if boxes is None and self.detector is not None:
                    boxes, boxes_valid = self._detect(left_dev)
                elif boxes is None:
                    boxes, boxes_valid = np.zeros((nb, 4), np.float32), np.zeros(nb, bool)
                boxes_dev = self._to_device(np.asarray(boxes, np.float32), dst.get("boxes"))
                valid_dev = self._to_device(np.asarray(boxes_valid, bool), dst.get("boxes_valid"))
            right_dev = self._to_device(np.asarray(right, np.float32), dst.get("right"))
            if static is None:
                steps.frame = FrameInput(left=left_dev, right=right_dev, boxes=boxes_dev, boxes_valid=valid_dev)
        with profiling.span("pipeline.dispatch"):
            reseed = (
                self.reinit_after_lost > 0 and self._consecutive_lost >= self.reinit_after_lost
            )
            if self._n_processed == 0 or reseed:
                out = steps.init()
                if reseed:
                    self.n_reinits += 1
                self._consecutive_lost = 0
            else:
                out = steps.track()
            self._n_processed += 1

            fidx = self._n_processed - 1
            if (
                self.local_ba_every > 0
                and fidx % self.local_ba_every == 0
                and steps.window_ba.ready(self._n_processed)
            ):
                T_cw, T_wc = steps.refine()
                # the closed-form rigid inverse; the reference's jnp.linalg.inv
                # agrees to float32 rounding (~1e-7)
                out = out._replace(T_cw=T_cw, T_wc=T_wc)
        with profiling.span("pipeline.readback"):
            if steps.capture:
                # the next replay overwrites the graphs' outputs and state
                out = TrackOutputs(*(x.clone() for x in out))

            # one-frame-deferred readback: consume frame t-1 after dispatching t
            prev = self._pending
            self._pending = (out, timestamp, self._queue_readback(out))
        if prev is not None:
            self._finalize(*prev)
        self.frame_times.append(time.perf_counter() - t0)
        return out

    def _queue_readback(self, out: TrackOutputs) -> tuple:
        """Queue the copy of what ``_finalize`` reads to the host: ->
        (pnp_ok, T_wc, the event after their copy, None on the CPU)."""
        if self._host_slots is None:
            return out.pnp_ok, out.T_wc, None
        ok, T_wc = self._host_slots[self._n_processed % 2]
        ok.copy_(out.pnp_ok, non_blocking=True)
        T_wc.copy_(out.T_wc, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return ok, T_wc, done

    def _finalize(self, out, timestamp: float, host: tuple) -> None:
        """Host-side consumption of a step's outputs: waits for this
        frame's readback event alone (the sync point)."""
        ok, T_wc, done = host
        with profiling.span("pipeline.wait"):
            if done is not None:
                done.synchronize()
        if bool(ok):
            self._consecutive_lost = 0
        else:
            self._consecutive_lost += 1
        with profiling.span("pipeline.append"):
            self.writer.append(T_wc.numpy(), timestamp)
        self.outputs.append(out)

    def flush(self) -> None:
        if self._pending is not None:
            self._finalize(*self._pending)
            self._pending = None

    def run(self, frames: Iterable, prefetch: bool = True) -> dict:
        """frames yields (idx, left, right, boxes, boxes_valid, timestamp)
        (io/kitti.iter_frames format).  Returns a summary dict."""
        it = _prefetch(frames) if prefetch else frames
        for _, left, right, boxes, bv, ts in it:
            if self.detector is not None:  # online detection replaces the offline boxes
                boxes, bv = None, None
            self.process_frame(left, right, boxes, bv, ts)
        self.flush()
        self.writer.close()
        times = np.array(self.frame_times[1:] if len(self.frame_times) > 1 else self.frame_times)
        return {
            "n_frames": len(self.frame_times),
            "median_s": float(np.median(times)) if len(times) else 0.0,
            "mean_s": float(np.mean(times)) if len(times) else 0.0,
            "fps": float(1.0 / np.median(times)) if len(times) else 0.0,
            "positions": self.writer.positions(),
        }
