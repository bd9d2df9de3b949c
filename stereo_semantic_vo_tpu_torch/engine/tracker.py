"""The per-frame tracking step: ORB, sparse stereo, two matching stages,
epipolar culling of dynamic points, RANSAC PnP, motion-only BA and the
ring-map update, all on fixed shapes with masks.

Port of ``stereo_semantic_vo_tpu.engine.tracker``.  Every guard is a
``torch.where``; nothing in ``init_step`` / ``track_step`` reads a device
value back to the host, so a caller can dispatch frame t while it consumes
frame t-1's outputs.  The frame index ``t`` is read from the state's device
counter and every ring write lands at a device offset, so one captured CUDA
graph of a step serves every frame (engine/graphs.py).  RANSAC draws under
``fold_in(PRNGKey(cfg.pnp.seed), t)`` on the device, as the reference does.

The steps' stages are scopes of the tracer (``utils/profiling.stage``):
``orb``, ``stereo`` (sparse disparity, or the dense volumes and SGM), and
in ``track_step`` ``match`` (sections 3-5), ``pnp`` (RANSAC), ``lm``
(motion-only BA and the pose's acceptance), then ``map`` (the map and
state writes).  Each stamps its start when a ring is current
(engine/graphs.StepGraphs) and does nothing otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_semantic_vo_tpu_torch.core import lie
from stereo_semantic_vo_tpu_torch.core.camera import Camera, backproject
from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.core.precision import f32_geometry
from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs, VOState, init_state
from stereo_semantic_vo_tpu_torch.kernels.matcher import fused_best_match, fused_best_match_plain
from stereo_semantic_vo_tpu_torch.ops import ba as ba_ops
from stereo_semantic_vo_tpu_torch.ops import epipolar as epi_ops
from stereo_semantic_vo_tpu_torch.ops import orb as orb_ops
from stereo_semantic_vo_tpu_torch.ops import pnp as pnp_ops
from stereo_semantic_vo_tpu_torch.ops import stereo as stereo_ops
from stereo_semantic_vo_tpu_torch.utils import profiling

_BIG = 1 << 30


class FrameInput(NamedTuple):
    left: torch.Tensor         # (H, W) float32 grayscale [0, 255]
    right: torch.Tensor        # (H, W) float32
    boxes: torch.Tensor        # (B, 4) float32 [x1, y1, x2, y2] detection boxes
    boxes_valid: torch.Tensor  # (B,) bool


def _resolve_matches(q_valid, best_tidx, best_dist, accept, n_train):
    """Many queries may claim one train keypoint; keep the lowest distance
    (ties: lowest query index) with one scatter-min over dist * Q + q.
    Returns per-train (matched, q_idx)."""
    Kq = q_valid.shape[0]
    code = best_dist.to(torch.int64) * Kq + torch.arange(Kq, device=q_valid.device)
    code = torch.where(accept & q_valid, code, _BIG)
    per_train = torch.full((n_train,), _BIG, dtype=torch.int64, device=q_valid.device)
    per_train = per_train.scatter_reduce(0, best_tidx.to(torch.int64), code, "amin")
    matched = per_train < _BIG
    return matched, torch.where(matched, per_train % Kq, 0)


def _project_uv(cam, T_cw, Xw):
    """Project (N, 3) world points under T_cw -> ((N, 2) pixels, (N,) depth)."""
    pc = lie.transform_points(T_cw, Xw)
    z = pc[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def _region_slots(frame: torch.Tensor, K: int, W: int) -> torch.Tensor:
    """(K,) slots of the ring region that belongs to ``frame`` (a 0-d
    device tensor)."""
    return (frame.to(torch.int64) % W) * K + torch.arange(K, device=frame.device)


def _set_region(arr: torch.Tensor, frame: torch.Tensor, K: int, W: int, src: torch.Tensor) -> torch.Tensor:
    """``arr`` with the ring region of ``frame`` replaced by ``src``: a copy
    at a device offset, the reference's ``dynamic_update_slice``."""
    return arr.index_copy(0, _region_slots(frame, K, W), src.to(arr.dtype))


def _set_row(arr: torch.Tensor, frame: torch.Tensor, W: int, src: torch.Tensor) -> torch.Tensor:
    """``arr`` with row ``frame % W`` replaced by ``src``."""
    return arr.index_copy(0, (frame.to(torch.int64) % W).reshape(1), src[None].to(arr.dtype))


def cull_dynamic(F, uv_last, uv, m3, in_box, slot3, map_bad, cfg: VOConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 4's rule: a last-frame match inside a box whose point lies
    farther than ``epipolar_threshold`` px from its epipolar line under the
    background's ``F`` is dynamic, and poisons its map slot (an OR over
    duplicate slots).  -> ((K,) dynamic, (M,) map_bad)."""
    dd = epi_ops.epipolar_distance(F, uv_last, uv)
    if cfg.use_semantics:
        dynamic = m3 & in_box & (dd > cfg.matcher.epipolar_threshold)
    else:
        dynamic = torch.zeros_like(m3)
    map_bad = map_bad.to(torch.uint8).scatter_reduce(0, slot3, dynamic.to(torch.uint8), "amax").to(torch.bool)
    return dynamic, map_bad


@f32_geometry
def init_step(state: VOState, frame: FrameInput, cfg: VOConfig) -> tuple[VOState, TrackOutputs]:
    """Map (re)initialization: back-project every keypoint with valid depth
    outside detection boxes at the current pose (identity on a fresh state;
    on a mid-sequence state this reseeds the map and keeps the pose)."""
    with profiling.stage("orb"):
        dev = frame.left.device
        cam = Camera.from_config(cfg.camera, dev)
        kp = orb_ops.extract_orb(frame.left, cfg.orb)
    with profiling.stage("stereo"):
        st = stereo_ops.sparse_disparity(frame.left, frame.right, kp.uv, kp.valid, cam, cfg.stereo)

    with profiling.stage("map"):
        in_box = epi_ops.in_box_mask(kp.uv, frame.boxes, frame.boxes_valid, cfg.matcher.box_margin_init)
        near = st.depth <= (cfg.camera.bf / cfg.camera.fx) * cfg.camera.th_depth
        create = kp.valid & st.valid & near & ~in_box

        t = torch.clamp_min(state.frame_idx + 1, 0)
        T_cw = state.T_cw
        Xw = lie.transform_points(lie.T_inv(T_cw), backproject(cam, kp.uv, st.depth)[None])[0]

        K = cfg.orb.max_keypoints
        W = cfg.window.window_frames
        uid = t * K + torch.arange(K, device=dev)
        new_state = state._replace(
            frame_idx=t,
            T_cw=T_cw,
            # a reseed follows a lost stretch: restart the motion model from rest
            velocity=torch.eye(4, dtype=state.velocity.dtype, device=dev),
            last_uv=kp.uv,
            last_desc=kp.desc,
            last_valid=kp.valid,
            map_Xw=_set_region(state.map_Xw, t, K, W, Xw),
            map_desc=_set_region(state.map_desc, t, K, W, kp.desc),
            map_valid=_set_region(state.map_valid, t, K, W, create),
            map_bad=_set_region(state.map_bad, t, K, W, torch.zeros_like(create)),
            map_create_id=_set_region(state.map_create_id, t, K, W, torch.where(create, t, -100)),
            map_uid=_set_region(state.map_uid, t, K, W, torch.where(create, uid, -1)),
            win_T_cw=_set_row(state.win_T_cw, t, W, T_cw),
            win_uv=_set_row(state.win_uv, t, W, kp.uv),
            win_disp=_set_row(state.win_disp, t, W, torch.where(st.valid, st.disparity, -1.0)),
        )
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return new_state, TrackOutputs(
        T_cw=T_cw, T_wc=lie.T_inv(T_cw),
        n_keypoints=torch.sum(kp.valid), n_stereo=torch.sum(st.valid),
        n_matches_last=zero, n_matches_map=zero, n_pnp_inliers=zero,
        n_ba_inliers=zero, n_new_points=torch.sum(create), n_culled_dynamic=zero,
        pnp_ok=torch.ones((), dtype=torch.bool, device=dev),
        kp_uv=kp.uv, obs_uid=torch.where(create, uid, -1), obs_valid=create,
    )


@f32_geometry
def track_step(state: VOState, frame: FrameInput, cfg: VOConfig) -> tuple[VOState, TrackOutputs]:
    # ---- 1+2. frontend
    with profiling.stage("orb"):
        dev = frame.left.device
        cam = Camera.from_config(cfg.camera, dev)
        K = cfg.orb.max_keypoints
        W = cfg.window.window_frames
        t = state.frame_idx + 1  # index of the frame being processed
        mcfg = cfg.matcher
        match = fused_best_match if mcfg.resolved_backend(dev) == "pallas" else fused_best_match_plain
        kp = orb_ops.extract_orb(frame.left, cfg.orb)
    with profiling.stage("stereo"):
        st = stereo_ops.sparse_disparity(frame.left, frame.right, kp.uv, kp.valid, cam, cfg.stereo)

    with profiling.stage("match"):
        age_ok = state.map_create_id > t - W
        live = state.map_valid & ~state.map_bad & age_ok

        # ---- 3. last-frame matching (gate < 15)
        last_slots = _region_slots(t - 1, K, W)
        last_has_mp = state.last_valid & live.index_select(0, last_slots)
        T_pred = state.velocity @ state.T_cw
        b_idx, b_dist, _ = match(state.last_desc, kp.desc, last_has_mp, kp.valid)
        b_idx = b_idx.to(torch.int64)
        accept3 = b_dist < mcfg.last_frame_max_dist
        if mcfg.search_radius_px > 0:
            # motion-prior gate: the winner must land near its map point's
            # projection under the constant-velocity prediction
            uv_pred3, z_pred3 = _project_uv(cam, T_pred, state.map_Xw[last_slots])
            d3 = torch.sum((kp.uv[b_idx] - uv_pred3) ** 2, dim=-1)
            accept3 = accept3 & (d3 <= mcfg.search_radius_px**2) & (z_pred3 > 0.05)
        m3, q3 = _resolve_matches(last_has_mp, b_idx, b_dist, accept3, K)
        slot3 = last_slots[q3]

        # ---- 4. semantic dynamic culling
        matched_uv_last = state.last_uv[q3]
        in_box_cur = epi_ops.in_box_mask(kp.uv, frame.boxes, frame.boxes_valid, mcfg.box_margin_match)
        background = m3 & ~in_box_cur
        F = epi_ops.fit_fundamental(matched_uv_last, kp.uv, background.to(torch.float32))
        dynamic, map_bad = cull_dynamic(F, matched_uv_last, kp.uv, m3, in_box_cur, slot3, state.map_bad, cfg)
        n_culled = torch.sum(dynamic)
        m3 = m3 & ~dynamic

        # ---- 5. local-map matching (gate < 30, ratio > 2) over regions older
        # than the last frame
        slot_ids = torch.arange(state.map_valid.shape[0], device=dev)
        in_last_region = (slot_ids // K) == ((t - 1) % W)
        map_candidates = live & ~in_last_region & ~map_bad
        cur_free = kp.valid & ~m3
        if cfg.use_local_map:
            mb_idx, mb_dist, mb_second = match(state.map_desc, kp.desc, map_candidates, cur_free)
            mb_idx = mb_idx.to(torch.int64)
            accept5 = (mb_dist < mcfg.local_map_max_dist) & (
                mb_second.to(torch.float32) > mcfg.local_map_ratio * mb_dist.to(torch.float32)
            )
            if mcfg.search_radius_px > 0:
                uv_pred5, z_pred5 = _project_uv(cam, T_pred, state.map_Xw)
                d5 = torch.sum((kp.uv[mb_idx] - uv_pred5) ** 2, dim=-1)
                accept5 = accept5 & (d5 <= mcfg.search_radius_px**2) & (z_pred5 > 0.05)
            m5, q5 = _resolve_matches(map_candidates, mb_idx, mb_dist, accept5, K)
            m5 = m5 & ~m3
        else:
            m5 = torch.zeros_like(m3)
            q5 = torch.zeros((K,), dtype=torch.int64, device=dev)

    with profiling.stage("pnp"):
        # ---- 6. pose estimation
        mp_slot = torch.where(m3, slot3, q5)
        has_obs = m3 | m5
        obs_Xw = state.map_Xw[mp_slot]
        ur = urm = None
        if cfg.ba.stereo_pose:
            ur = kp.uv[:, 0] - st.disparity
            urm = has_obs & st.valid
        pnp = pnp_ops.ransac_pnp(
            obs_Xw, kp.uv, has_obs, cam, cfg.pnp,
            t=t, T_seed=T_pred, ur=ur, ur_mask=urm,
        )
    with profiling.stage("lm"):
        ba = ba_ops.motion_only_ba(pnp.T_cw, obs_Xw, kp.uv, has_obs, cam, cfg.ba, ur=ur, ur_mask=urm)
        # accept the BA pose only if it keeps most of the RANSAC consensus
        ba_keeps = torch.sum(ba.inlier_mask) >= torch.clamp_min(pnp.n_inliers // 2, cfg.pnp.min_inliers)
        T_est = torch.where(ba_keeps, ba.T_cw, pnp.T_cw)
        ok = pnp.ok
        if cfg.pnp.pose_jump_max_m > 0:
            # a pose that teleports away from the motion prediction is an
            # aliased or degenerate consensus
            jump = torch.linalg.vector_norm((T_est @ lie.T_inv(T_pred))[:3, 3])
            plausible = jump <= cfg.pnp.pose_jump_max_m
            if cfg.pnp.pose_jump_escape_inliers > 0:
                plausible = plausible | (pnp.n_inliers >= cfg.pnp.pose_jump_escape_inliers)
            ok = ok & plausible & torch.all(torch.isfinite(T_est))
        T_cw = torch.where(ok, T_est, T_pred)

    with profiling.stage("map"):
        # ---- 7. map maintenance: every current keypoint's map point lands in
        # region t (matched -> copy of its slot, created -> fresh entry)
        in_box_create = epi_ops.in_box_mask(kp.uv, frame.boxes, frame.boxes_valid, mcfg.box_margin_init)
        near = st.depth <= (cfg.camera.bf / cfg.camera.fx) * cfg.camera.th_depth
        create = kp.valid & st.valid & near & ~has_obs & ~in_box_create
        T_wc = lie.T_inv(T_cw)
        Xw_new = lie.transform_points(T_wc, backproject(cam, kp.uv, st.depth)[None])[0]

        src_Xw = torch.where(has_obs[:, None], state.map_Xw[mp_slot], Xw_new)
        src_desc = torch.where(has_obs[:, None], state.map_desc[mp_slot], kp.desc)
        src_create = torch.where(has_obs, state.map_create_id[mp_slot], t)
        src_uid = torch.where(
            has_obs, state.map_uid[mp_slot].to(torch.int64), t * K + torch.arange(K, device=dev)
        )
        src_valid = has_obs | create
        src_bad = has_obs & map_bad[mp_slot]

        velocity = T_cw @ lie.T_inv(state.T_cw)
        if cfg.pnp.max_velocity_m > 0:
            vel_sane = (torch.linalg.vector_norm(velocity[:3, 3]) <= cfg.pnp.max_velocity_m) & torch.all(
                torch.isfinite(velocity)
            )
            velocity = torch.where(vel_sane, velocity, state.velocity)

        new_state = state._replace(
            frame_idx=t,
            T_cw=T_cw,
            velocity=velocity,
            last_uv=kp.uv,
            last_desc=kp.desc,
            last_valid=kp.valid,
            map_Xw=_set_region(state.map_Xw, t, K, W, src_Xw),
            map_desc=_set_region(state.map_desc, t, K, W, src_desc),
            map_valid=_set_region(state.map_valid, t, K, W, src_valid),
            map_bad=_set_region(map_bad, t, K, W, src_bad),
            map_create_id=_set_region(state.map_create_id, t, K, W, torch.where(src_valid, src_create, -100)),
            map_uid=_set_region(state.map_uid, t, K, W, torch.where(src_valid, src_uid, -1)),
            win_T_cw=_set_row(state.win_T_cw, t, W, T_cw),
            win_uv=_set_row(state.win_uv, t, W, kp.uv),
            win_disp=_set_row(state.win_disp, t, W, torch.where(st.valid, st.disparity, -1.0)),
        )
    return new_state, TrackOutputs(
        T_cw=T_cw,
        T_wc=T_wc,
        n_keypoints=torch.sum(kp.valid),
        n_stereo=torch.sum(st.valid),
        n_matches_last=torch.sum(m3),
        n_matches_map=torch.sum(m5),
        n_pnp_inliers=pnp.n_inliers,
        n_ba_inliers=torch.sum(ba.inlier_mask),
        n_new_points=torch.sum(create),
        n_culled_dynamic=n_culled,
        pnp_ok=ok,
        kp_uv=kp.uv,
        obs_uid=torch.where(src_valid, src_uid, -1),
        obs_valid=src_valid,
    )


def make_tracker(cfg: VOConfig, device: torch.device | str = "cuda"):
    """Returns (state0, step) where step(state, frame) runs ``init_step`` on
    its first call and ``track_step`` after, choosing from a host count as
    the pipeline does (the state's counter stays on the device)."""
    state0 = init_state(cfg, device)
    calls = 0

    def step(state: VOState, frame: FrameInput):
        nonlocal calls
        calls += 1
        if calls == 1:
            return init_step(state, frame, cfg)
        return track_step(state, frame, cfg)

    return state0, step
