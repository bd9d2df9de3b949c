"""Sequence driver: load frames, run the tracking step, write trajectories,
report per-frame times.

Port of ``stereo_semantic_vo_tpu.engine.pipeline.VOPipeline`` without the
online detector (ROADMAP A10) and without the mesh-sharded window BA
(ROADMAP A11): those arguments raise ``NotImplementedError``.  With
``local_ba_every=N`` the window BA (engine/window_ba.py) refines the state
every N-th frame once the window is full.  Frame decode runs on a prefetch
thread; frames are copied to the device from pinned memory without
blocking; frame t-1's outputs are read back after frame t is dispatched, so
the host never waits on the step it just queued.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Iterable

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.core import lie
from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.engine.state import init_state
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu_torch.engine.window_ba import refine_state
from stereo_semantic_vo_tpu_torch.engine.trajectory import TrajectoryWriter


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
    ):
        if detector is not None:
            raise NotImplementedError("online detection is not ported yet (ROADMAP A10)")
        if ba_mesh is not None:
            raise NotImplementedError("the sharded window BA is not ported yet (ROADMAP A11)")
        self.cfg = cfg
        self.local_ba_every = local_ba_every
        self.device = torch.device(device)
        self.state = init_state(cfg, self.device)
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
        self._pending: tuple[Any, float] | None = None
        self._n_processed = 0

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(a))  # a writable copy: callers may pass read-only views
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def process_frame(
        self,
        left: np.ndarray,
        right: np.ndarray,
        boxes: np.ndarray | None,
        boxes_valid: np.ndarray | None,
        timestamp: float,
    ):
        t0 = time.perf_counter()
        if boxes is None:
            nb = self.cfg.semantic.max_boxes
            boxes = np.zeros((nb, 4), np.float32)
            boxes_valid = np.zeros(nb, bool)
        frame = FrameInput(
            left=self._to_device(np.asarray(left, np.float32)),
            right=self._to_device(np.asarray(right, np.float32)),
            boxes=self._to_device(np.asarray(boxes, np.float32)),
            boxes_valid=self._to_device(np.asarray(boxes_valid, bool)),
        )
        reseed = (
            self.reinit_after_lost > 0 and self._consecutive_lost >= self.reinit_after_lost
        )
        if self._n_processed == 0 or reseed:
            self.state, out = init_step(self.state, frame, self.cfg)
            if reseed:
                self.n_reinits += 1
            self._consecutive_lost = 0
        else:
            self.state, out = track_step(self.state, frame, self.cfg)
        self._n_processed += 1

        fidx = self._n_processed - 1
        if (
            self.local_ba_every > 0
            and fidx % self.local_ba_every == 0
            and self._n_processed >= self.cfg.window.window_frames
        ):
            self.state = refine_state(self.state, self.cfg)
            # the closed-form rigid inverse; the reference's jnp.linalg.inv
            # agrees to float32 rounding (~1e-7)
            out = out._replace(T_cw=self.state.T_cw, T_wc=lie.T_inv(self.state.T_cw))

        # one-frame-deferred readback: consume frame t-1 after dispatching t
        prev = self._pending
        self._pending = (out, timestamp)
        if prev is not None:
            self._finalize(*prev)
        self.frame_times.append(time.perf_counter() - t0)
        return out

    def _finalize(self, out, timestamp: float) -> None:
        """Host-side consumption of a step's outputs (the sync point)."""
        if bool(out.pnp_ok):
            self._consecutive_lost = 0
        else:
            self._consecutive_lost += 1
        self.writer.append(out.T_wc.cpu().numpy(), timestamp)
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
