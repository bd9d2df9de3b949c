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

The reference steps frame t with the boxes that the program's step tracked
it with (``Sample.boxes``): the frame's own offline boxes, or, online, the
detections of the frame before.  In a cell whose configuration has a
``detector``, the check holds those boxes to the plain darknet reference
(``vo_bench/reference/detector.py``) run on the same image:

* ``det_head_gap``: the largest |program - reference| over every entry of
  the head maps that produced the boxes, over the RMS of the reference's
  maps;
* ``det_box_gap_px``: the largest coordinate gap between a box of the
  program and the reference's box that it pairs with, one to one and the
  nearest pairs first; where a box finds no pair (one side has a box that
  the other lacks), the frame's diagonal, as far as a box can be off;
* ``det_valid_mismatch``: how many boxes found no pair.  A reading beside
  the others: the TF32 control moves the logits by ~0.01 and turns no
  validity on half its seeds, so this count has no upper reading, and
  ``det_box_gap_px`` holds the boxes' validity instead.

A box is a decision on rounded numbers: a score against the threshold and
against the other scores, an IoU against the NMS threshold.  A candidate
whose fate in the reference turns on a decision closer to its edge than
``SCORE_EDGE`` or ``IOU_EDGE`` may be paired but is not due: the program's
rounding could keep or drop it.  Every other box of the reference is due.
``det_edge_share``, the share of the reference's kept and optional
candidates that are optional over all samples, says how much of the boxes
that leaves unchecked.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vo_bench.reference import detector as ref_detector
from vo_bench.reference import lie as ref_lie
from vo_bench.reference import state as ref_state
from vo_bench.reference import tracker as ref_tracker
from vo_bench.reference import window_ba as ref_window_ba
from vo_bench.reference.config import VOConfig as RefConfig
from vo_bench.reference.precision import matmul_precision

TRACKER = ("pose_gap_m", "rot_gap_rad", "map_gap_m", "map_gap_median_m", "state_mismatch")
DETECTOR = ("det_head_gap", "det_box_gap_px", "det_valid_mismatch", "det_edge_share")
READ = TRACKER + DETECTOR
# sound runs' head gaps (at most 3.2e-4 of an RMS near 1 over 25 seeds on
# the H100) move a score above the 0.8 threshold by at most 0.16 x 3.2e-4
# (the logistic's slope there), two scores' gap by twice that, ~1e-4, and
# their boxes by ~1e-3 px, an IoU by far less than IOU_EDGE
SCORE_EDGE = 2e-4
IOU_EDGE = 3e-3
# a box farther than this from every box of the other side has no pair:
# distinct candidates lie a cell (~113 px on a 1241x376 frame) or an
# anchor's size apart
PAIR_PX = 8.0
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
    boxes: np.ndarray        # (n_boxes, 4) float32: the boxes the program's step tracked frame t with
    boxes_valid: np.ndarray  # (n_boxes,) bool
    det_frame: int | None = None   # the frame whose detection made ``boxes``; None: no detection
    det_heads: tuple | None = None  # that detection's head maps (1, C, h, w), as the program produced them


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


def pair_boxes(prog: np.ndarray, due: np.ndarray, optional: np.ndarray) -> tuple[float, int]:
    """The program's boxes (P, 4) paired one to one with the reference's due
    and optional boxes, the nearest pairs first, by the largest coordinate
    gap, none farther apart than ``PAIR_PX``.  -> (the largest gap of a
    pair, how many of the program's boxes and of the due boxes found no
    pair)."""
    ref = np.concatenate([due, optional]).astype(np.float64)
    gap = np.abs(prog[:, None, :] - ref[None, :, :]).max(axis=2) if len(prog) and len(ref) else np.zeros((0, 0))
    paired_p, paired_r, worst = set(), set(), 0.0
    for p, r in sorted(np.ndindex(*gap.shape), key=lambda pr: gap[pr]):
        if gap[p, r] <= PAIR_PX and p not in paired_p and r not in paired_r:
            paired_p.add(p)
            paired_r.add(r)
            worst = max(worst, float(gap[p, r]))
    return worst, len(prog) - len(paired_p) + sum(r not in paired_r for r in range(len(due)))


def compare_detection(sample: Sample, ref: ref_detector.Detections | None,
                      diagonal: float) -> tuple[dict, tuple[int, int]]:
    """The detector's numbers of one sampled frame, against the reference's
    detection of the same image (None: no detection precedes the frame);
    ``diagonal``: the frame's, in px.  -> (numbers, (the reference's
    optional candidates, its kept and optional candidates))."""
    valid = np.asarray(sample.boxes_valid, bool)
    if ref is None:   # the step tracks with no box
        return {"det_head_gap": 0.0, "det_box_gap_px": diagonal if valid.any() else 0.0,
                "det_valid_mismatch": float(valid.sum())}, (0, 0)
    prog = [torch.as_tensor(np.asarray(h)) for h in sample.det_heads or ()]
    want = [h.double().cpu() for h in ref.heads]
    rms = float(torch.cat([h.flatten() for h in want]).pow(2).mean().sqrt())
    if [p.shape for p in prog] != [w.shape for w in want]:
        head = math.inf
    else:
        head = max(float((p.double() - w).abs().max()) for p, w in zip(prog, want)) / rms
    n = len(valid)   # the reference's slots cut to the program's, as the pipeline cuts them
    due = ref.boxes[:n][ref.valid[:n] & ~ref.edge[:n]]
    box, unpaired = pair_boxes(np.asarray(sample.boxes, np.float64)[valid], due, ref.optional)
    out = {"det_head_gap": head, "det_box_gap_px": diagonal if unpaired else box,
           "det_valid_mismatch": float(unpaired)}
    return ({k: (math.inf if not math.isfinite(v) else v) for k, v in out.items()},
            (len(ref.optional), len(due) + len(ref.optional)))


def check_samples(samples: list[Sample], frame_of, vo: dict, device, tf32: bool = False,
                  detector: ref_detector.Detector | None = None) -> dict[str, float]:
    """The largest of each number over ``samples``; ``frame_of(stream, t)``
    gives the scene's frame t, whose images the program was handed.  Runs
    the reference on ``device``, a sample at a time; with a reference
    ``detector`` (a cell whose configuration has one) the detector's
    numbers too, ``det_edge_share`` over all samples."""
    cfg = RefConfig.from_dict(vo)
    worst = {k: 0.0 for k in (READ if detector is not None else TRACKER)}
    optional = candidates = 0
    for s in samples:
        frame = frame_of(s.stream, s.t)._replace(boxes=s.boxes, boxes_valid=s.boxes_valid)
        after, T_wc = reference_step(cfg, s.before, frame, s.kind, s.refine, device, tf32)
        numbers = compare(s, after, T_wc)
        del after, T_wc
        if detector is not None:
            ref = None
            if s.det_frame is not None:
                gray = torch.from_numpy(np.ascontiguousarray(frame_of(s.stream, s.det_frame).left)).to(device)
                ref = detector.detect(gray / 255.0, edges=(SCORE_EDGE, IOU_EDGE))
            det, (o, c) = compare_detection(s, ref, math.hypot(*frame.left.shape))
            numbers.update(det)
            optional, candidates = optional + o, candidates + c
        for k, v in numbers.items():
            worst[k] = max(worst[k], v)
    if detector is not None:
        worst["det_edge_share"] = optional / candidates if candidates else 0.0
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
