"""What decides ``correct``: the program's tracked frames held against the
plain reference (``vo_bench/reference``).

The tracker is a chain of steps, each a function of the state before it
and the frame.  The check follows the program step by step from its own
state: for each sampled frame t of a stream it takes the program's state
after frame t-1 and the frame the program was handed, runs the
reference's step (``init_step`` or ``track_step``, then the window refine
where the program refined), and compares with what the program produced:
the pose that reached the host, and the whole state after frame t.  The
start, frame 0's ``init_step``, is checked from the reference's own fresh
state.

The numbers, each the largest over the sampled frames and streams; a
cell's limits file (``vo_bench/limits/<cell>.json``) gives the limit of
each that decides ``correct`` there:

* ``pose_gap_m``: the distance between the camera positions (T_wc) of the
  program's host pose and the reference's;
* ``rot_gap_rad``: the angle between their rotations (float64);
* ``map_gap_m``: the largest distance between the program's and the
  reference's map points over the ring slots that both hold, and
  ``map_gap_median_m`` the median of those distances;
* ``state_mismatch``: how many entries of the state's exact fields differ
  (frame counter, the frame's keypoints and descriptors with their
  validity, the map's descriptors, validity, dynamic flags, creation frames
  and ids, the window's keypoints and disparities).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vo_bench.reference import lie as ref_lie
from vo_bench.reference import state as ref_state
from vo_bench.reference import tracker as ref_tracker
from vo_bench.reference import window_ba as ref_window_ba
from vo_bench.reference.config import VOConfig as RefConfig
from vo_bench.reference.precision import matmul_precision

READ = ("pose_gap_m", "rot_gap_rad", "map_gap_m", "map_gap_median_m", "state_mismatch")
EXACT_FIELDS = ("frame_idx", "last_uv", "last_desc", "last_valid", "map_desc", "map_valid", "map_bad",
                "map_create_id", "map_uid", "win_uv", "win_disp")


class Sample(NamedTuple):
    """One tracked frame of one stream, as the program produced it."""

    stream: int
    t: int
    kind: str                # "init" or "track"
    refine: bool             # the window refine ran after the step
    before: tuple | None     # the program's state after frame t-1 (VOState fields); None: a fresh state
    after: tuple             # the program's state after frame t
    host_T_wc: np.ndarray    # (4, 4) the pose of frame t that reached the host


def _ref_state(fields, device) -> ref_state.VOState:
    return ref_state.VOState(*(torch.as_tensor(x).to(device) for x in fields))


def rotation_angle(R: np.ndarray) -> float:
    """atan2(|vee(R - R^T)| / 2, (tr R - 1) / 2) in float64."""
    R = np.asarray(R, np.float64)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(vee) / 2.0, (np.trace(R) - 1.0) / 2.0))


def reference_step(cfg: RefConfig, before, frame, kind: str, refine: bool, device, tf32: bool = False):
    """-> (state after, T_wc) of the reference's step from ``before`` (a
    fresh state where None) on ``frame`` (a ``scene.Frame``)."""
    state = ref_state.init_state(cfg, device) if before is None else _ref_state(before, device)
    inp = ref_tracker.FrameInput(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                   for a in (frame.left, frame.right, frame.boxes, frame.boxes_valid)))
    with matmul_precision(tf32):
        step = ref_tracker.init_step if kind == "init" else ref_tracker.track_step
        state, out = step(state, inp, cfg)
        T_wc = out.T_wc
        if refine:
            state = ref_window_ba.refine_state(state, cfg)
            T_wc = ref_lie.T_inv(state.T_cw)
    return state, T_wc


def compare(sample: Sample, ref_after, ref_T_wc) -> dict[str, float]:
    """The numbers of one sampled frame."""
    names = ref_state.VOState._fields
    prog = {n: torch.as_tensor(x).cpu() for n, x in zip(names, sample.after)}
    ref = {n: x.cpu() for n, x in zip(names, ref_after)}
    host = np.asarray(sample.host_T_wc, np.float64)
    want = ref_T_wc.cpu().double().numpy()
    pose = float(np.linalg.norm(host[:3, 3] - want[:3, 3]))
    rot = rotation_angle(host[:3, :3].T @ want[:3, :3])
    both = prog["map_valid"] & ref["map_valid"]
    map_gap = map_median = 0.0
    if bool(both.any()):
        d = torch.linalg.vector_norm((prog["map_Xw"] - ref["map_Xw"]).double(), dim=-1)[both]
        map_gap, map_median = float(d.max()), float(d.median())
    mismatch = 0
    for n in EXACT_FIELDS:
        a, b = prog[n], ref[n]
        if a.shape != b.shape:
            mismatch += max(a.numel(), b.numel())
        else:
            mismatch += int((a != b).sum())
    out = {"pose_gap_m": pose, "rot_gap_rad": rot, "map_gap_m": map_gap, "map_gap_median_m": map_median,
           "state_mismatch": float(mismatch)}
    return {k: (math.inf if not math.isfinite(v) else v) for k, v in out.items()}


def check_samples(samples: list[Sample], frame_of, vo: dict, device, tf32: bool = False) -> dict[str, float]:
    """The largest of each number over ``samples``; ``frame_of(stream, t)``
    gives the frame the program was handed.  Runs the reference on
    ``device``, a sample at a time."""
    cfg = RefConfig.from_dict(vo)
    worst = {k: 0.0 for k in READ}
    for s in samples:
        after, T_wc = reference_step(cfg, s.before, frame_of(s.stream, s.t), s.kind, s.refine, device, tf32)
        for k, v in compare(s, after, T_wc).items():
            worst[k] = max(worst[k], v)
        del after, T_wc
    return worst


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}): every number that the
    cell's limits name at or under its limit."""
    unknown = set(limits) - set(numbers)
    if unknown or not limits:
        raise KeyError(f"limits for numbers the check does not read: {sorted(unknown)}")
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, shown
