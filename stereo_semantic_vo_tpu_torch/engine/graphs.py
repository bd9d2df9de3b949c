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

Each step function owns a ring of the tracer (utils/profiling.py), made
current around its call while the tracer is on when the ``StepGraphs`` is
built: the stamps of the step's stages (``init_step`` / ``track_step``'s
``orb`` ... ``map``, the state copy-back counting to ``map``; the refine's
``refine``) and of its end are nodes of the captured graph, so every
replay writes them on the card's clock.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.core import lie
from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.core.cuda_graph import Graph, capture_pool
from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs, VOState
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu_torch.engine.window_ba import WindowBA
from stereo_semantic_vo_tpu_torch.utils import profiling


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
        # a ring of stage stamps a step function; none while tracing is off
        self.rings: dict[str, profiling.StampRing] = {
            name: profiling.ring(name, self.device) for name in ("init_step", "track_step", "refine_state")
        } if profiling.enabled() else {}
        if not capture:
            self.state = state
            return
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.state = VOState(*(x.clone() for x in state))
        self.pool = capture_pool(self.device)
        self.graphs = {name: Graph(lambda name=name, fn=fn: self._stamped(name, fn), self.pool, self.device)
                       for name, fn in (("init_step", lambda: self._step(init_step)),
                                        ("track_step", lambda: self._step(track_step)),
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

    def _stamped(self, name: str, fn):
        """``fn()`` with step function ``name``'s ring current: what a
        graph captures."""
        with profiling.stamping(self.rings.get(name)):
            return fn()

    def _step(self, fn) -> TrackOutputs:
        new, out = fn(self.state, self.frame, self.cfg)
        _copy_state(self.state, new)
        return out

    def _refine(self) -> tuple[torch.Tensor, torch.Tensor]:
        with profiling.stage("refine"):
            _copy_state(self.state, self.window_ba.refine_window(self.state)[0])
            return self.state.T_cw, lie.T_inv(self.state.T_cw)

    def _call(self, name: str, eager):
        """One call of step function ``name``, noted in its ring: a replay
        of its graph, or ``eager()`` with the ring current."""
        ring = self.rings.get(name)
        if ring is not None:
            ring.called()
        if self.capture:
            return self.graphs[name]()
        with profiling.stamping(ring):
            return eager()

    def _eager(self, fn) -> TrackOutputs:
        self.state, out = fn(self.state, self.frame, self.cfg)
        return out

    def _eager_refine(self) -> tuple[torch.Tensor, torch.Tensor]:
        with profiling.stage("refine"):
            self.state = self.window_ba.refine_window(self.state)[0]
            return self.state.T_cw, lie.T_inv(self.state.T_cw)

    def init(self) -> TrackOutputs:
        return self._call("init_step", lambda: self._eager(init_step))

    def track(self) -> TrackOutputs:
        return self._call("track_step", lambda: self._eager(track_step))

    def refine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The window refine -> the refined (T_cw, T_wc).  Its gate on the
        host count of frames is the caller's (``self.window_ba.ready``); the
        device gate runs inside."""
        return self._call("refine_state", self._eager_refine)
