"""Carry configuration and state between the JAX package and this one.

The main path has no learned weights: its parameters are the config, the
BRIEF pattern (a seeded numpy draw both packages make identically) and the
tracker state.  These functions take plain dataclasses and numpy arrays, so
this module imports no JAX.
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
    VOState on ``device``.  uint32 descriptors become int32 bit patterns; the
    ``*_pm1`` fields are dropped."""
    out = {}
    for name in VOState._fields:
        a = np.asarray(arrays[name])
        if name == "frame_idx":
            out[name] = int(a)
            continue
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)  # copy: JAX buffers are read-only
    return VOState(**out)


def state_to_numpy(state: VOState) -> dict[str, np.ndarray]:
    """VOState -> numpy arrays in the JAX VOState's dtypes (descriptors as
    uint32, frame_idx as an int32 scalar), without the ``*_pm1`` fields."""
    out = {}
    for name, v in state._asdict().items():
        if name == "frame_idx":
            out[name] = np.asarray(v, np.int32)
            continue
        a = v.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in ("last_desc", "map_desc") else a
    return out
