"""Data-parallel tracking: B independent sequence streams on a mesh's
devices.

Port of ``stereo_semantic_vo_tpu.parallel.dp_tracker``.  The reference
stacks B states on a leading axis and runs one jitted step under ``vmap``
and ``shard_map``, ``lax.cond`` choosing ``init_step`` or ``track_step``
per stream on the device counter.  Here the batch of states is a list of
per-stream ``VOState`` and the choice is a host test on a count the
tracker keeps for each stream: the last step's state of a stream and the
state it handed out for it have known counts, and any other state (a fresh
``init_state``, a loaded checkpoint) has its ``frame_idx`` read once, the
only read from the device, before its step.  A stream may start at any
frame: give it a fresh ``init_state`` (``frame_idx == -1``) and its next
frame runs ``init_step``.

Stream b lives on ``devices[b % len(devices)]`` and holds an
``engine.graphs.StepGraphs`` of its own.  On a card, the counterpart of
the reference's one jitted program is CUDA graphs: each stream has static
frame and state buffers, an init graph and a track graph, captured at the
stream's first init and first track, and a memory pool of its own, since
the streams' graphs run at once.  A step copies each stream's frame into
its static buffers and replays its graph on a CUDA stream of its own, so
the device may overlap the streams; the host dispatches B uploads and B
replays and reads nothing back (on states it handed out).  As in the
reference, a state handed out is a value: it is a copy of the stream's
static state, made on the device after the step, which no later replay
changes, and every state passed in is copied into the stream's static
state, so passing an earlier one back rewinds the stream as the eager
steps do.  ``capture=False`` dispatches the eager steps instead (the
counterpart of ``jax.disable_jit``); the CPU always runs them, in order,
and ``capture=True`` there raises.

A step's program spans (utils/profiling.span): each stream's ``dp.upload``
(its frame into the static buffers) and ``dp.dispatch`` (its replay), then
``dp.state_copy`` (the states handed out) and ``dp.stack`` (the stacked
outputs).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.engine.graphs import StepGraphs
from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs, VOState, init_state
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput
from stereo_semantic_vo_tpu_torch.parallel.mesh import Mesh
from stereo_semantic_vo_tpu_torch.utils import profiling


def _devices(devices) -> list[torch.device]:
    if isinstance(devices, Mesh):
        return list(devices.devices)
    return [torch.device(d) for d in devices]


def batched_init_state(cfg: VOConfig, batch: int, devices=("cuda",)) -> list[VOState]:
    """``batch`` fresh states, stream b on ``devices[b % len(devices)]``
    (a list of devices or a data-axis Mesh)."""
    devs = _devices(devices)
    return [init_state(cfg, devs[b % len(devs)]) for b in range(batch)]


def make_dp_tracker(devices, cfg: VOConfig, capture: bool | None = None):
    """-> step(states, frames) -> (states, outputs).  ``states`` is the list
    of per-stream VOStates from :func:`batched_init_state`; ``frames`` a
    FrameInput whose tensors carry the streams on their leading axis.
    ``outputs`` is a TrackOutputs of the streams' outputs stacked on the
    leading axis, on the first device.  ``capture`` (default: on a CUDA
    device) replays each stream's steps from CUDA graphs."""
    devs = _devices(devices)
    if capture and any(d.type != "cuda" for d in devs):
        raise ValueError(f"CUDA graphs need CUDA devices, got {devs}")
    steps: dict[int, StepGraphs] = {}
    streams: dict[int, torch.cuda.Stream] = {}
    # stream b -> [(the state it handed out, its frame index), (the one its last step took, its index)]
    known: dict[int, list[tuple[VOState, int]]] = {}

    def stream_steps(b: int, state: VOState) -> StepGraphs:
        """Stream b's step functions, continuing from ``state``."""
        dev = state.T_cw.device
        sg = steps.get(b)
        if sg is None or sg.device != dev:
            sg = steps[b] = StepGraphs(cfg, state, dev.type == "cuda" if capture is None else capture)
        elif sg.state is not state:
            sg.load_state(state)
        return sg

    def step(states: Sequence[VOState], frames: FrameInput) -> tuple[list[VOState], TrackOutputs]:
        if frames.left.shape[0] != len(states):
            raise ValueError(f"{len(states)} states and {frames.left.shape[0]} frames")
        ran, outs, used = [], [], []
        for b, state in enumerate(states):
            dev = state.T_cw.device
            fr = FrameInput(*(x[b] for x in frames))
            frame_idx = next((i for st, i in known.get(b, ()) if st is state), None)
            if frame_idx is None:
                frame_idx = int(state.frame_idx)
            sg = stream_steps(b, state)
            if dev.type != "cuda":
                with profiling.span("dp.upload"):
                    sg.frame = FrameInput(*(x.to(dev) for x in fr))
                with profiling.span("dp.dispatch"):
                    out = sg.init() if frame_idx < 0 else sg.track()
            else:
                s = streams.get(b)
                if s is None or s.device != dev:
                    s = streams[b] = torch.cuda.Stream(dev)
                s.wait_stream(torch.cuda.current_stream(dev))  # the frames, and the last reads of this stream
                with torch.cuda.stream(s):
                    with profiling.span("dp.upload"):
                        if sg.capture:
                            static = sg.frame_buffers(tuple(fr.left.shape), fr.boxes.shape[0])
                            for dst, x in zip(static, fr):
                                dst.copy_(x, non_blocking=True)
                        else:
                            sg.frame = FrameInput(*(x.to(dev, non_blocking=True) for x in fr))
                    with profiling.span("dp.dispatch"):
                        out = sg.init() if frame_idx < 0 else sg.track()
                # the caching allocator may hand out a block again once its
                # tensor is freed: mark the inputs used on the side stream
                # (under graphs the stream's own buffers hold the rest)
                eager = () if sg.capture else (*sg.frame, *(v for v in state if isinstance(v, torch.Tensor)))
                for x in (*fr, *eager):
                    x.record_stream(s)
                used.append((dev, s))
            ran.append((b, state, frame_idx, sg))
            outs.append(out)
        for dev, s in used:
            torch.cuda.current_stream(dev).wait_stream(s)
        for x in (x for out in outs for x in out if x.is_cuda):  # stacked on the main streams below
            x.record_stream(torch.cuda.current_stream(x.device))
        new_states = []
        with profiling.span("dp.state_copy"):
            for b, state, frame_idx, sg in ran:
                # a static state is copied on the main stream, after its replay
                new = VOState(*(x.clone() for x in sg.state)) if sg.capture else sg.state
                known[b] = [(new, max(frame_idx + 1, 0)), (state, frame_idx)]
                new_states.append(new)
        first = devs[0]
        # the stack copies the outputs before the next replay overwrites them
        with profiling.span("dp.stack"):
            stacked = TrackOutputs(*(torch.stack([x.to(first, non_blocking=True) for x in field])
                                     for field in zip(*outs)))
        return new_states, stacked

    step.steps = steps  # stream b -> its StepGraphs (graphs, capture ms, pool bytes, replays)
    return step
