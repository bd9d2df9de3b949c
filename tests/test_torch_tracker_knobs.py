"""PyTorch port, the tracker's branches behind knobs that no other test sets,
against the JAX package.

tests/test_torch_slice.py's four frames (``_kitti_knobs``, ``_frame``: the
renderer's 240x320 frames, a box on frame 2) go through both packages with
one knob flipped: ``use_local_map=False``, ``ba.stereo_pose=True`` (the
stereo residual row in RANSAC's polish and in motion-only BA), and a
``pnp.pose_jump_max_m`` of half a frame's step with
``pose_jump_escape_inliers`` at 20 (the consensus escapes the gate) and at
10**6 (the gate rejects the pose and the step keeps the motion
prediction).  Each variant is held to the slice's rule: poses within 1e-3 m
and 1e-3 rad, ``pnp_ok`` equal, frame-0 counters exact and later ones
within max(2, 2%).  Each also shows that its branch was taken.  The
default configuration runs in the port alone, as the branches' baseline.
``ransac_pnp`` with the stereo row is held to JAX's on JAX's own draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.camera import Camera as JCam
from stereo_semantic_vo_tpu.core.config import VOConfig
from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu.ops import pnp as JP
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from stereo_semantic_vo_tpu_torch.interop import config_from_jax
from stereo_semantic_vo_tpu_torch.ops import pnp as TP
from tests.test_torch_pose import _pnp_data
from tests.test_torch_slice import COUNTERS, N_FRAMES, _frame, _kitti_knobs
from tests.test_tracker import TX_STEP
from tests.torch_parity import n, one_torch_thread, rot_angle, t  # noqa: F401

JUMP_MAX_M = 0.5 * TX_STEP  # below one frame's step: the gate trips at frame 1, where the velocity is the identity


def _jump_gate(escape):
    return lambda c: dataclasses.replace(
        c, pnp=dataclasses.replace(c.pnp, pose_jump_max_m=JUMP_MAX_M, pose_jump_escape_inliers=escape))


VARIANTS = {
    "no_local_map": lambda c: dataclasses.replace(c, use_local_map=False),
    "stereo_pose": lambda c: dataclasses.replace(c, ba=dataclasses.replace(c.ba, stereo_pose=True)),
    "jump_escape": _jump_gate(20),
    "jump_reject": _jump_gate(10**6),
}


def _run(cfg, step_mod, state, frame_of):
    outs, before = [], []
    for i in range(N_FRAMES):
        before.append((n(state.velocity), n(state.T_cw)))
        state, out = (step_mod.init_step if i == 0 else step_mod.track_step)(state, frame_of(i), cfg)
        outs.append(out)
    return outs, before


def _port(cfg):
    return _run(cfg, TT, t_init_state(cfg, "cpu"), lambda i: TT.FrameInput(*(t(a) for a in _frame(i))))


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg_t = _kitti_knobs()
    out = {"default": (None, *_port(cfg_t))}
    for name, flip in VARIANTS.items():
        cj = flip(cfg_j)
        oj, _ = _run(cj, JT, j_init_state(cj), lambda i: JT.FrameInput(*(jnp.asarray(a) for a in _frame(i))))
        out[name] = ([jax.tree.map(np.asarray, o) for o in oj], *_port(flip(cfg_t)))
    return out


@pytest.mark.parametrize("frame", range(N_FRAMES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(runs, variant, frame):
    out_j, out_t, _ = runs[variant]
    oj, ot = out_j[frame], out_t[frame]
    Tj, Tt = oj.T_wc.astype(np.float64), n(ot.T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
    assert bool(ot.pnp_ok) == bool(oj.pnp_ok)
    for name in COUNTERS:
        a, b = int(getattr(oj, name)), int(getattr(ot, name))
        assert abs(a - b) <= (0 if frame == 0 else max(2, int(0.02 * a))), (name, a, b)
    if variant != "jump_reject":  # a rejected pose keeps the prediction, by design off the ground truth
        assert np.linalg.norm(Tt[:3, 3] - [frame * TX_STEP, 0, 0]) < 0.05


def _jumps(out_t, before):
    """Per tracked frame: (pnp_ok, the step's pose against the motion
    prediction in metres) as the gate measures it, read where the pose was
    kept."""
    res = []
    for out, (vel, T_prev) in zip(out_t[1:], before[1:]):
        T_pred = vel.astype(np.float64) @ T_prev.astype(np.float64)
        res.append((bool(out.pnp_ok), float(np.linalg.norm((n(out.T_cw) @ np.linalg.inv(T_pred))[:3, 3]))))
    return res


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_takes_its_branch(runs, variant):
    out_j, out_t, before = runs[variant]
    _, base_t, _ = runs["default"]
    if variant == "no_local_map":
        assert all(int(o.n_matches_map) == 0 for o in out_j + out_t)
        assert any(int(o.n_matches_map) > 0 for o in base_t)
    elif variant == "stereo_pose":
        # the stereo row moves the pose, within the ground-truth bound above
        assert any(not np.array_equal(n(a.T_cw), n(b.T_cw)) for a, b in zip(out_t[1:], base_t[1:]))
    elif variant == "jump_escape":
        jumps = _jumps(out_t, before)
        assert any(ok and jump > JUMP_MAX_M for ok, jump in jumps), jumps
        assert all(bool(o.pnp_ok) for o in out_t)
    else:
        cfg_t = _kitti_knobs()[1]
        rejected = [i for i, o in enumerate(out_t[1:], 1)
                    if not bool(o.pnp_ok) and int(o.n_pnp_inliers) >= cfg_t.pnp.min_inliers]
        assert 1 in rejected, [(bool(o.pnp_ok), int(o.n_pnp_inliers)) for o in out_t]
        for i in rejected:  # the step kept the motion prediction
            vel, T_prev = before[i]
            np.testing.assert_array_equal(n(out_t[i].T_cw), n(t(vel) @ t(T_prev)))


@pytest.mark.parametrize("seeded", [False, True])
def test_ransac_pnp_stereo_row_matches_jax(seeded):
    """``ransac_pnp(ur=..., ur_mask=...)`` on the OpenCV golden's points and
    JAX's own draws: the polish's stereo row gives JAX's pose within 1e-4
    and its inlier set exactly; with ``T_seed`` too, as the tracker calls it."""
    cfg = VOConfig.kitti("00")
    tcfg = config_from_jax(cfg)
    jc, tc = JCam.from_config(cfg.camera), TCam.from_config(tcfg.camera, "cpu")
    X, uv = _pnp_data()
    valid = np.ones(len(X), bool)
    key = jax.random.PRNGKey(3)
    mono = JP.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jc, cfg.pnp, key=key)
    T_ref = n(mono.T_cw)
    pc = X @ T_ref[:3, :3].T + T_ref[:3, 3]
    ur = (uv[:, 0] - cfg.camera.bf / pc[:, 2] + np.random.RandomState(0).normal(0, 0.3, len(X))).astype(np.float32)
    urm = np.arange(len(X)) % 3 != 0
    seed = None
    if seeded:
        seed = T_ref.copy()
        seed[:3, 3] += [0.02, -0.01, 0.04]
    idx = n(JP._sample_indices(key, jnp.asarray(valid), cfg.pnp.num_hypotheses, cfg.pnp.sample_size))
    rj = JP.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jc, cfg.pnp, key=key,
                       T_seed=None if seed is None else jnp.asarray(seed), ur=jnp.asarray(ur), ur_mask=jnp.asarray(urm))
    rt = TP.ransac_pnp(t(X), t(uv), t(valid), tc, tcfg.pnp, idx=t(idx),
                       T_seed=None if seed is None else t(seed), ur=t(ur), ur_mask=t(urm))
    np.testing.assert_allclose(n(rt.T_cw), n(rj.T_cw), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(rt.inlier_mask), n(rj.inlier_mask))
    assert bool(rt.ok) == bool(rj.ok) and int(rt.n_inliers) == int(rj.n_inliers)
    # the stereo row was used: the polish lands elsewhere than the mono one
    assert not np.allclose(n(rj.T_cw), T_ref, rtol=0, atol=1e-7)
