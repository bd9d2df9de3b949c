"""Windowed local bundle adjustment over the tracker's sliding map: joint
refinement of the last W frame poses and the landmarks they observe, built
from the state's ring buffers and solved by ``local_ba.local_ba``.
Landmarks are keyed by their stable uid, so the same physical point links
observations across frames despite the ring's per-frame copies; the uid
join is a dense equality-matrix build.  After refinement, landmark
positions are written back into every ring copy of each uid and the newest
pose replaces ``state.T_cw``.  The solve always runs, and its result is
kept or dropped by ``torch.where`` on "the window is full and at least 8
landmarks survive".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference import lie
from vo_bench.reference.camera import Camera
from vo_bench.reference.config import VOConfig
from vo_bench.reference.precision import f32_geometry
from vo_bench.reference.state import VOState
from vo_bench.reference import local_ba as local_ba_ops


class ObsTensors(NamedTuple):
    obs_uv: torch.Tensor       # (W, M, 2) pixel observations
    obs_mask: torch.Tensor     # (W, M) bool
    obs_ur: torch.Tensor       # (W, M) right-image u (stereo BA edge)
    obs_r_mask: torch.Tensor   # (W, M) bool: the observation carries stereo depth
    point_valid: torch.Tensor  # (M,) bool: primary, live, seen >= 2 frames
    primary_idx: torch.Tensor  # (M,) int64: slot of each uid's primary copy
    has_primary: torch.Tensor  # (M,) bool
    n_obs: torch.Tensor        # () int64 total observations


@f32_geometry
def build_observations(
    map_uid: torch.Tensor,     # (M,)
    map_valid: torch.Tensor,   # (M,)
    map_bad: torch.Tensor,     # (M,)
    frame_idx: torch.Tensor,   # () the state's frame counter
    win_uid: torch.Tensor,     # (W, K) per-frame keypoint uid bindings
    win_uv: torch.Tensor,      # (W, K, 2)
    win_valid: torch.Tensor,   # (W, K)
    W: int,
    K: int,
    win_disp: torch.Tensor | None = None,  # (W, K) disparity, -1 where invalid
) -> ObsTensors:
    """Device-side uid join: ring slots x window keypoints -> observation
    tensors.  One uid can live in several slots; the newest region's copy
    (ties by slot index) is the primary and alone receives observations."""
    M = map_uid.shape[0]
    dev = map_uid.device
    slot = torch.arange(M, device=dev)
    live = map_valid & ~map_bad & (map_uid >= 0)

    # recency of each ring region: the last frame that wrote region r is the
    # largest t' <= frame_idx with t' mod W == r
    rank = frame_idx - torch.remainder(frame_idx - slot // K, W)

    # elect the primary copy per uid: max (rank, slot) among equal-uid slots
    eq = (map_uid[:, None] == map_uid[None, :]) & live[:, None] & live[None, :]
    code = rank * M + slot
    best = torch.amax(torch.where(eq, code[None, :], -1), dim=1)
    primary = live & (code == best)
    # per-slot pointer to its primary copy (first hit, as jnp.argmax)
    pri_hit = eq & primary[None, :]
    has_primary = torch.any(pri_hit, dim=1)
    primary_idx = torch.argmax(pri_hit.to(torch.uint8), dim=1)

    if win_disp is None:
        win_disp = torch.full(win_uid.shape, -1.0, dtype=win_uv.dtype, device=dev)
    # (W, M, K) one-hot: does window keypoint k bind this slot's uid?
    E = (map_uid[None, :, None] == win_uid[:, None, :]) & win_valid[:, None, :] & primary[None, :, None]
    cnt = torch.sum(E, dim=2)
    obs_uv = (E.to(win_uv.dtype) @ win_uv) / torch.clamp_min(cnt, 1)[..., None]
    # stereo edge: u_R = u_L - disparity where the keypoint measured one
    Er = E & (win_disp > 0)[:, None, :]
    cnt_r = torch.sum(Er, dim=2)
    ur = (Er.to(win_uv.dtype) @ (win_uv[..., 0] - win_disp)[..., None])[..., 0] / torch.clamp_min(cnt_r, 1)
    obs_mask, obs_r_mask = cnt > 0, cnt_r > 0

    seen = torch.sum(obs_mask, dim=0)
    point_valid = primary & (seen >= 2)  # < 2 views constrain nothing
    obs_mask = obs_mask & point_valid[None, :]
    obs_r_mask = obs_r_mask & obs_mask
    return ObsTensors(
        obs_uv=obs_uv, obs_mask=obs_mask, obs_ur=ur, obs_r_mask=obs_r_mask,
        point_valid=point_valid, primary_idx=primary_idx, has_primary=has_primary,
        n_obs=torch.sum(obs_mask),
    )


def _write_back(map_Xw, refined_points, point_valid, primary_idx, has_primary):
    """Broadcast each refined primary position to every ring copy of its uid."""
    take = has_primary & point_valid[primary_idx]
    return torch.where(take[:, None], refined_points[primary_idx], map_Xw)


def _window_view(state: VOState, W: int, K: int):
    """Oldest->newest window tensors from the state.  The ring region
    (f % W) is frame f's keypoint->map binding; ``order`` holds the ring
    regions of the window frames, oldest first, gathered on the device."""
    order = (state.frame_idx - (W - 1) + torch.arange(W, device=state.win_T_cw.device)) % W

    def ordered(x):
        return x.index_select(0, order)

    poses = ordered(state.win_T_cw)
    win_uid = ordered(state.map_uid.reshape(W, K))
    win_valid = ordered((state.map_valid & (state.map_uid >= 0)).reshape(W, K))
    return order, poses, win_uid, ordered(state.win_uv), win_valid, ordered(state.win_disp)


def _trim_and_gate(state: VOState, obs: ObsTensors, poses, cam: Camera, cfg: VOConfig):
    """Seed-pose trim and solvability gate.  An observation already far off
    at the seed poses is a wrong match, which joint LM would drag every
    window pose toward.  Returns (obs_mask, point_valid, can): ``can`` is
    the device flag "the window is full and at least 8 landmarks
    survive"."""
    obs_mask = obs.obs_mask
    if cfg.ba.trim_px > 0:
        pc = lie.transform_points(poses, state.map_Xw)  # (W, M, 3)
        z = pc[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
        u = cam.fx * pc[..., 0] / safe_z + cam.cx
        v = cam.fy * pc[..., 1] / safe_z + cam.cy
        r2 = (u - obs.obs_uv[..., 0]) ** 2 + (v - obs.obs_uv[..., 1]) ** 2
        obs_mask = obs_mask & (r2 <= cfg.ba.trim_px**2) & (z > 0.05)
    seen = torch.sum(obs_mask, dim=0)
    point_valid = obs.point_valid & (seen >= 2)
    obs_mask = obs_mask & point_valid[None, :]
    return obs_mask, point_valid, (state.frame_idx + 1 >= poses.shape[0]) & (torch.sum(point_valid) >= 8)


@f32_geometry
def refine_state(state: VOState, cfg: VOConfig) -> VOState:
    """Window refinement of the state, without host syncs.  The LM solve
    always runs and is kept only where ``can`` holds: before the window
    holds W frames, or with fewer than 8 landmarks, the state's values pass
    through unchanged."""
    W = cfg.window.window_frames
    K = cfg.orb.max_keypoints
    cam = Camera.from_config(cfg.camera, state.T_cw.device)
    order, poses, win_uid, win_uv, win_valid, win_disp = _window_view(state, W, K)
    obs = build_observations(
        state.map_uid, state.map_valid, state.map_bad, state.frame_idx,
        win_uid, win_uv, win_valid, W, K, win_disp,
    )
    obs_mask, point_valid, can = _trim_and_gate(state, obs, poses, cam, cfg)
    res = local_ba_ops.local_ba(
        poses, state.map_Xw, obs.obs_uv, obs_mask, point_valid, cam, cfg.ba,
        obs_ur=obs.obs_ur, obs_r_mask=obs.obs_r_mask & obs_mask,
    )
    new_Xw = _write_back(state.map_Xw, res.points, point_valid, obs.primary_idx, obs.has_primary)
    return state._replace(
        map_Xw=torch.where(can, new_Xw, state.map_Xw),
        T_cw=torch.where(can, res.poses[-1], state.T_cw),
        win_T_cw=torch.where(can, state.win_T_cw.index_copy(0, order, res.poses), state.win_T_cw),
    )
