"""Checkpoint / resume for the VO state.

Port of ``stereo_semantic_vo_tpu.utils.checkpoint``.  The reference has no
checkpointing (a crash loses the map and the pose); here the whole
:class:`~stereo_semantic_vo_tpu_torch.engine.state.VOState` is saved as a
flat .npz, written atomically through a ``.tmp`` file, and resume continues
tracking mid-sequence with the sliding-window map intact.

Entries are keyed by field name plus a schema version (v2), not by
position, so a reordered or renamed field cannot load into another; an
incompatible file fails with a clear error.  The file holds the JAX
package's dtypes (``interop.state_to_numpy``: uint32 descriptors, an int32
``frame_idx``), and ``load_state`` also reads a file the JAX package's
``save_state`` wrote: its ``*_desc_pm1`` entries are skipped.
"""

from __future__ import annotations

import os

import numpy as np

from stereo_semantic_vo_tpu_torch.engine.state import VOState
from stereo_semantic_vo_tpu_torch.interop import state_from_numpy, state_to_numpy

_SCHEMA_KEY = "__schema__"
_SCHEMA_VERSION = 2


def save_state(path: str, state: VOState) -> None:
    """Write ``state`` to ``path`` (reads the state back from its device)."""
    flat = state_to_numpy(state)
    flat[_SCHEMA_KEY] = np.asarray(_SCHEMA_VERSION)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_state(path: str, template: VOState) -> VOState:
    """Read a checkpoint onto ``template``'s device; ``frame_idx`` comes
    back as a 0-d int32 tensor there."""
    with np.load(path) as data:
        if _SCHEMA_KEY not in data:
            raise ValueError(
                f"{path}: positional (schema-v1) checkpoint from before VOState "
                "gained win_T_cw/win_uv/win_disp — incompatible; re-run and "
                "re-save, or load with the matching older release."
            )
        version = int(data[_SCHEMA_KEY])
        if version != _SCHEMA_VERSION:
            raise ValueError(
                f"{path}: checkpoint schema v{version}, expected v{_SCHEMA_VERSION}"
            )
        missing = [k for k in VOState._fields if k not in data]
        if missing:
            raise ValueError(f"{path}: checkpoint is missing VOState fields {missing}")
        return state_from_numpy({k: data[k] for k in VOState._fields}, template.T_cw.device)
