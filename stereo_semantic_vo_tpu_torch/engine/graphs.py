"""CUDA graphs of the tracking step: the port's counterpart of the
reference's ``jax.jit`` programs ``init_step`` and ``track_step``
(engine/tracker.py), ``refine_state`` and ``WindowBA._refine_jit`` (the
landmark-sharded refine, engine/window_ba.py).  The graphs themselves are
``core/cuda_graph.Graph``; the pipeline captures its jitted ``detect``
with one as well (engine/pipeline.py).

:class:`StepGraphs` holds a pipeline's static ``FrameInput`` and
``VOState`` buffers, a pool, and one graph for each of ``init_step``,
``track_step`` and the window refine (its ``WindowBA``'s: ``refine_state``,
or with a mesh the sharded refine, collectives included); each copies the
new state back into the static state inside the graph, so the step's
frame counter, ring offsets and RANSAC draws (all on the device) advance
on every replay.  With ``capture=False``, which the CPU requires, it calls
the eager functions on its state instead.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.core import lie
from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.core.cuda_graph import Graph, capture_pool
from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs, VOState
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu_torch.engine.window_ba import WindowBA


def _copy_state(dst: VOState, src: VOState) -> None:
    """Copy every field of ``src`` into ``dst``'s tensors (a field that is
    the same tensor in both is left alone)."""
    for a, b in zip(dst, src):
        if a is not b:
            a.copy_(b)


class StepGraphs:
    """A pipeline's step functions on static buffers: ``init()``,
    ``track()`` and ``refine()`` run one step on ``self.frame`` and
    ``self.state``.  With ``capture`` each is a :class:`Graph` (the state
    is copied into buffers of its own); without, the eager function.  The
    refine is ``window_ba``'s (default: ``WindowBA(cfg)``, which is
    ``refine_state``)."""

    def __init__(self, cfg: VOConfig, state: VOState, capture: bool, window_ba: WindowBA | None = None):
        self.cfg, self.capture = cfg, capture
        self.window_ba = window_ba or WindowBA(cfg)
        self.device = state.T_cw.device
        self.frame: FrameInput | None = None
        if not capture:
            self.state = state
            return
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.state = VOState(*(x.clone() for x in state))
        self.pool = capture_pool(self.device)
        self.graphs = {name: Graph(fn, self.pool, self.device) for name, fn in (
            ("init_step", lambda: self._step(init_step)), ("track_step", lambda: self._step(track_step)),
            ("refine_state", self._refine))}

    def frame_buffers(self, shape: tuple[int, int], n_boxes: int) -> FrameInput:
        """The static frame buffers, made on the first call; a frame of
        another shape raises (a graph replays fixed shapes)."""
        if self.frame is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            self.frame = FrameInput(torch.zeros(shape, **f32), torch.zeros(shape, **f32),
                                    torch.zeros((n_boxes, 4), **f32),
                                    torch.zeros((n_boxes,), dtype=torch.bool, device=self.device))
        elif tuple(self.frame.left.shape) != tuple(shape) or self.frame.boxes.shape[0] != n_boxes:
            raise ValueError(f"frame {tuple(shape)} with {n_boxes} boxes; the step graphs hold "
                             f"{tuple(self.frame.left.shape)} with {self.frame.boxes.shape[0]}")
        return self.frame

    def load_state(self, state: VOState) -> None:
        """Continue from ``state``: copied into the static state."""
        if self.capture:
            _copy_state(self.state, state)
        else:
            self.state = state

    def _step(self, fn) -> TrackOutputs:
        new, out = fn(self.state, self.frame, self.cfg)
        _copy_state(self.state, new)
        return out

    def _refine(self) -> tuple[torch.Tensor, torch.Tensor]:
        _copy_state(self.state, self.window_ba.refine_window(self.state)[0])
        return self.state.T_cw, lie.T_inv(self.state.T_cw)

    def init(self) -> TrackOutputs:
        if self.capture:
            return self.graphs["init_step"]()
        self.state, out = init_step(self.state, self.frame, self.cfg)
        return out

    def track(self) -> TrackOutputs:
        if self.capture:
            return self.graphs["track_step"]()
        self.state, out = track_step(self.state, self.frame, self.cfg)
        return out

    def refine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The window refine -> the refined (T_cw, T_wc).  Its gate on the
        host count of frames is the caller's (``self.window_ba.ready``); the
        device gate runs inside."""
        if self.capture:
            return self.graphs["refine_state"]()
        self.state = self.window_ba.refine_window(self.state)[0]
        return self.state.T_cw, lie.T_inv(self.state.T_cw)
