"""PyTorch port, windowed local BA (engine/window_ba.py) and
``VOPipeline(local_ba_every=1)`` against the JAX package.

Six frames of tests/test_tracker.py's renderer (240x320, K=256, 3 levels)
with ``VOConfig.kitti()``'s upright BRIEF and BA knobs (trim 10 px, the
block build behind "auto", which is the plain einsum build on the CPU in
both packages).  The window refines every frame from frame 3 on, as
tests/test_window_ba.py drives it.  Tolerances: the uid join (masks, primary copies, counts) exact;
refined and per-frame poses within 1e-3 m and 1e-3 rad (the slice test's
bound: RANSAC draws differ between the packages, and LM amplifies float32
rounding); refined landmarks within 1e-2 m."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core.config import VOConfig as JVO
from stereo_semantic_vo_tpu.engine import window_ba as JW
from stereo_semantic_vo_tpu.engine.pipeline import VOPipeline as JPipe
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine import window_ba as TW
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline as TPipe
from tests.test_tracker import CFG, TX_STEP, empty_boxes, render
from tests.torch_parity import n, rot_angle

N_FRAMES = 6
WIN = CFG.window.window_frames
JCFG = dataclasses.replace(CFG, orb=dataclasses.replace(CFG.orb, steer=False), ba=JVO.kitti().ba)
TCFG = interop.config_from_jax(JCFG)


def _frames():
    boxes, bv = (np.asarray(a) for a in empty_boxes())
    for i in range(N_FRAMES):
        left, right = (np.asarray(a) for a in render(i))
        yield i, left, right, boxes, bv, 0.1 * i


@pytest.fixture(scope="module")
def jax_states():
    """JAX states just before and just after each refine (frames 3-5)."""
    state = j_init_state(JCFG)
    pre, post = {}, {}
    for i, left, right, boxes, bv, _ in _frames():
        frame = FrameInput(*(jax.numpy.asarray(a) for a in (left, right, boxes, bv)))
        state, _ = (init_step if i == 0 else track_step)(state, frame, JCFG)
        if i >= WIN - 1:
            pre[i] = {k: np.asarray(v) for k, v in state._asdict().items()}
            state = JW.refine_state(state, JCFG)
            post[i] = {k: np.asarray(v) for k, v in state._asdict().items()}
    return pre, post


@pytest.fixture(scope="module")
def pipelines():
    jp = JPipe(JCFG, write_trajectory=False, local_ba_every=1)
    jp.run(_frames(), prefetch=False)
    tp = TPipe(TCFG, device="cpu", local_ba_every=1)
    tp.run(_frames(), prefetch=False)
    return [n(o.T_wc) for o in jp.outputs], [n(o.T_wc) for o in tp.outputs]


def _assert_pose_close(Ta, Tb, tol_m=1e-3, tol_rad=1e-3):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    assert np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) <= tol_m
    assert rot_angle(Ta[:3, :3].T @ Tb[:3, :3]) <= tol_rad


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_pipeline_local_ba_matches_jax(pipelines, frame):
    jposes, tposes = pipelines
    assert len(tposes) == N_FRAMES
    _assert_pose_close(tposes[frame], jposes[frame])
    # and it tracks the ground truth, as tests/test_window_ba.py requires
    assert np.linalg.norm(tposes[frame][:3, 3] - [frame * TX_STEP, 0, 0]) < 0.06


def _obs_from_numpy(st, package):
    W, K = WIN, CFG.orb.max_keypoints
    if package == "jax":
        s = JW.VOState(**{k: jax.numpy.asarray(v) for k, v in st.items()})
        _, _, uid, uv, valid, disp = JW._window_view(s, W, K)
        return JW.build_observations(s.map_uid, s.map_valid, s.map_bad, s.frame_idx, uid, uv, valid, W, K, disp)
    s = interop.state_from_numpy(st, "cpu")
    _, _, uid, uv, valid, disp = TW._window_view(s, W, K)
    return TW.build_observations(s.map_uid, s.map_valid, s.map_bad, s.frame_idx, uid, uv, valid, W, K, disp)


@pytest.mark.parametrize("frame", range(WIN - 1, N_FRAMES))
def test_build_observations_exact(jax_states, frame):
    pre, _ = jax_states
    want, got = _obs_from_numpy(pre[frame], "jax"), _obs_from_numpy(pre[frame], "torch")
    for name in ("obs_mask", "obs_r_mask", "point_valid", "primary_idx", "has_primary", "n_obs"):
        np.testing.assert_array_equal(n(getattr(got, name)), n(getattr(want, name)), err_msg=name)
    for name in ("obs_uv", "obs_ur"):
        np.testing.assert_array_equal(n(getattr(got, name)), n(getattr(want, name)), err_msg=name)
    assert int(got.point_valid.sum()) > 20 and int(got.n_obs) > 50


@pytest.mark.parametrize("frame", range(WIN - 1, N_FRAMES))
def test_refine_state_matches_jax(jax_states, frame):
    pre, post = jax_states
    got = TW.refine_state(interop.state_from_numpy(pre[frame], "cpu"), TCFG)
    want = post[frame]
    _assert_pose_close(n(got.T_cw), want["T_cw"])
    for f in range(WIN):
        _assert_pose_close(n(got.win_T_cw[f]), want["win_T_cw"][f])
    np.testing.assert_allclose(n(got.map_Xw), want["map_Xw"], rtol=0, atol=1e-2)
    # the refine moved the state (it is not the pass-through)
    assert not np.array_equal(n(got.map_Xw), pre[frame]["map_Xw"])


def test_refine_state_passes_through_before_the_window_is_full(jax_states):
    pre, _ = jax_states
    st = interop.state_from_numpy(pre[WIN - 1], "cpu")._replace(frame_idx=torch.tensor(WIN - 2, dtype=torch.int32))
    got = TW.refine_state(st, TCFG)
    for name, x in st._asdict().items():
        assert torch.equal(getattr(got, name), x), name


def test_refine_state_keeps_the_state_when_too_few_landmarks(jax_states):
    """The solvability gate (>= 8 landmarks) selects with torch.where."""
    pre, _ = jax_states
    st = interop.state_from_numpy(pre[WIN], "cpu")
    st = st._replace(map_valid=torch.zeros_like(st.map_valid))
    out = TW.refine_state(st, TCFG)
    for name in ("T_cw", "win_T_cw", "map_Xw"):
        assert torch.equal(getattr(out, name), getattr(st, name)), name


def test_write_back_matches_jax():
    """Each refined primary position reaches every ring copy of its uid;
    slots without a valid primary keep their position.  Exact."""
    rng = np.random.RandomState(4)
    M = 64
    args = (
        rng.normal(0, 10, (M, 3)).astype(np.float32),
        rng.normal(0, 10, (M, 3)).astype(np.float32),
        rng.rand(M) > 0.3,
        rng.randint(0, M, M),
        rng.rand(M) > 0.2,
    )
    want = JW._write_back(*(jax.numpy.asarray(a) for a in args))
    got = TW._write_back(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert not np.array_equal(n(got), args[0]) and np.any(n(got) == args[0])
