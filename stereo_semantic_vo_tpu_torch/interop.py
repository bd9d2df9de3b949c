"""Carry configuration and state between the JAX package and this one.

The main path has no learned weights: its parameters are the config, the
BRIEF pattern (a seeded numpy draw both packages make identically) and the
tracker state; the detector's are its folded darknet params, and the
trainer's its raw params, momentum and two counters.  A batch of
JAX states (the data-parallel tracker's, stacked on a leading axis) maps
onto the port's list of per-stream states.  These functions take plain
dataclasses and numpy arrays, so this module imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.core import config as C
from stereo_semantic_vo_tpu_torch.engine.state import VOState

_SECTIONS = {
    "camera": C.CameraConfig,
    "orb": C.ORBConfig,
    "stereo": C.StereoConfig,
    "matcher": C.MatcherConfig,
    "pnp": C.PnPConfig,
    "ba": C.BAConfig,
    "semantic": C.SemanticConfig,
    "window": C.WindowConfig,
}
# the reference's state fields that exist only for the TPU's matrix unit
_DROPPED = ("last_desc_pm1", "map_desc_pm1")


def config_from_jax(cfg: Any) -> C.VOConfig:
    """A ``stereo_semantic_vo_tpu`` VOConfig (or any dataclass with the same
    fields) -> this package's VOConfig."""
    d = dataclasses.asdict(cfg)
    return C.VOConfig(
        **{k: _SECTIONS[k](**v) if k in _SECTIONS else v for k, v in d.items()}
    )


def state_from_numpy(arrays: Mapping[str, Any], device: torch.device | str = "cuda") -> VOState:
    """The JAX VOState's fields as numpy arrays (``{k: np.asarray(v)}``) ->
    VOState on ``device``.  uint32 descriptors become int32 bit patterns,
    ``frame_idx`` a 0-d int32 tensor; the ``*_pm1`` fields are dropped."""
    out = {}
    for name in VOState._fields:
        a = np.asarray(arrays[name])
        if name == "frame_idx":
            a = a.astype(np.int32)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)  # copy: JAX buffers are read-only
    return VOState(**out)


def state_to_numpy(state: VOState) -> dict[str, np.ndarray]:
    """VOState -> numpy arrays in the JAX VOState's dtypes (descriptors as
    uint32, frame_idx as an int32 scalar), without the ``*_pm1`` fields."""
    out = {}
    for name, v in state._asdict().items():
        a = v.detach().cpu().numpy()
        if name == "frame_idx":
            a = a.astype(np.int32)
        out[name] = a.view(np.uint32) if name in ("last_desc", "map_desc") else a
    return out


def states_from_numpy(arrays: Mapping[str, Any], devices=("cuda",)) -> list[VOState]:
    """A batched JAX VOState's fields as numpy arrays, stacked on a leading
    stream axis -> the per-stream VOStates of ``parallel/dp_tracker``,
    stream b on ``devices[b % len(devices)]``."""
    batch = np.asarray(arrays["frame_idx"]).shape[0]
    return [state_from_numpy({k: np.asarray(v)[b] for k, v in arrays.items()}, devices[b % len(devices)])
            for b in range(batch)]


def states_to_numpy(states: list[VOState]) -> dict[str, np.ndarray]:
    """Per-stream VOStates -> numpy arrays stacked on a leading stream axis,
    in the batched JAX VOState's dtypes."""
    per = [state_to_numpy(s) for s in states]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def params_to_numpy(params: Mapping[Any, Mapping[str, Any]]) -> dict[int, dict[str, np.ndarray]]:
    """A detector's folded params ({layer: {"w": HWIO, "b"}}, e.g. the JAX
    detector's ``params``) as float32 numpy arrays, for
    ``models/yolo.YoloDetector.from_params``."""
    return {int(k): {n: np.asarray(v, np.float32) for n, v in p.items()} for k, p in params.items()}


def _oihw(k: str, v, device) -> torch.Tensor:
    a = np.asarray(v, np.float32)
    if k == "w":  # HWIO -> OIHW
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.from_numpy(np.array(a, order="C")).to(device)  # copy: JAX buffers are read-only


def train_state_from_numpy(params: Mapping[Any, Mapping[str, Any]], momentum: Mapping[Any, Mapping[str, Any]],
                           batch_num: int, seen: int, device: torch.device | str = "cuda"):
    """The JAX ``TrainState``'s fields (params and momentum as numpy trees,
    e.g. through ``params_to_numpy``; conv weights HWIO) -> the port's
    ``models/yolo_train.TrainState`` on ``device`` (conv weights OIHW),
    for ``YoloTrainer.load_state``."""
    from stereo_semantic_vo_tpu_torch.models.yolo_train import TrainState

    def tree(ps):
        return {int(li): {k: _oihw(k, v, device) for k, v in p.items()} for li, p in ps.items()}

    def counter(v) -> torch.Tensor:
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    return TrainState(params=tree(params), momentum=tree(momentum), batch_num=counter(batch_num), seen=counter(seen))


def train_state_to_numpy(state) -> dict[str, Any]:
    """The port's ``TrainState`` -> ``{"params", "momentum", "batch_num",
    "seen"}`` in the JAX ``TrainState``'s layout: numpy float32 trees with
    HWIO conv weights, int32 counters."""

    def tree(ps):
        out = {}
        for li, p in ps.items():
            out[li] = {}
            for k, v in p.items():
                a = v.detach().cpu().numpy()
                out[li][k] = np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) if k == "w" else a
        return out

    return {"params": tree(state.params), "momentum": tree(state.momentum),
            "batch_num": np.int32(int(state.batch_num)), "seen": np.int32(int(state.seen))}
