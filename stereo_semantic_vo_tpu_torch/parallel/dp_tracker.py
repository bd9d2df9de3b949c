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

Stream b lives on ``devices[b % len(devices)]``.  On a card each stream is
enqueued on a CUDA stream of its own, so the device may overlap the
streams' kernels; the host dispatches them one after another.  ``step``
on states it handed out reads nothing back to the host.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs, VOState, init_state
from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu_torch.parallel.mesh import Mesh


def _devices(devices) -> list[torch.device]:
    if isinstance(devices, Mesh):
        return list(devices.devices)
    return [torch.device(d) for d in devices]


def batched_init_state(cfg: VOConfig, batch: int, devices=("cuda",)) -> list[VOState]:
    """``batch`` fresh states, stream b on ``devices[b % len(devices)]``
    (a list of devices or a data-axis Mesh)."""
    devs = _devices(devices)
    return [init_state(cfg, devs[b % len(devs)]) for b in range(batch)]


def make_dp_tracker(devices, cfg: VOConfig):
    """-> step(states, frames) -> (states, outputs).  ``states`` is the list
    of per-stream VOStates from :func:`batched_init_state`; ``frames`` a
    FrameInput whose tensors carry the streams on their leading axis.
    ``outputs`` is a TrackOutputs of the streams' outputs stacked on the
    leading axis, on the first device."""
    devs = _devices(devices)
    streams: dict[int, torch.cuda.Stream] = {}
    # stream b -> [(the state its last step took, its frame index), (the one it handed out, its index)]
    known: dict[int, list[tuple[VOState, int]]] = {}

    def step(states: Sequence[VOState], frames: FrameInput) -> tuple[list[VOState], TrackOutputs]:
        if frames.left.shape[0] != len(states):
            raise ValueError(f"{len(states)} states and {frames.left.shape[0]} frames")
        new_states, outs, used = [], [], []
        for b, state in enumerate(states):
            dev = state.T_cw.device
            fr = FrameInput(*(x[b] for x in frames))
            frame_idx = next((i for st, i in known.get(b, ()) if st is state), None)
            if frame_idx is None:
                frame_idx = int(state.frame_idx)
            run = init_step if frame_idx < 0 else track_step
            if dev.type != "cuda":
                fr = FrameInput(*(x.to(dev) for x in fr))
                new, out = run(state, fr, cfg)
            else:
                s = streams.get(b)
                if s is None or s.device != dev:
                    s = streams[b] = torch.cuda.Stream(dev)
                s.wait_stream(torch.cuda.current_stream(dev))  # the frames, and the last reads of this state
                with torch.cuda.stream(s):
                    fr = FrameInput(*(x.to(dev, non_blocking=True) for x in fr))
                    new, out = run(state, fr, cfg)
                # the caching allocator may hand out a block again once its
                # tensor is freed: mark the inputs used on the side stream
                for x in (*fr, *(v for v in state if isinstance(v, torch.Tensor))):
                    x.record_stream(s)
                used.append((dev, s))
            known[b] = [(state, frame_idx), (new, max(frame_idx + 1, 0))]
            new_states.append(new)
            outs.append(out)
        for dev, s in used:
            torch.cuda.current_stream(dev).wait_stream(s)
        for x in (x for out in outs for x in out if x.is_cuda):  # stacked on the main streams below
            x.record_stream(torch.cuda.current_stream(x.device))
        first = devs[0]
        stacked = TrackOutputs(*(torch.stack([x.to(first, non_blocking=True) for x in field])
                                 for field in zip(*outs)))
        return new_states, stacked

    return step
