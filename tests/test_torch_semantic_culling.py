"""PyTorch port, dynamic-object culling against the JAX package.

tests/test_semantic_culling.py's mover scene (a 40x40 textured patch at the
far plane's depth, moving 6 px a frame vertically, off the horizontal
epipolar lines, under a box 5 px outside it) goes through both packages on
the CPU with tests/test_tracker.py's ``CFG``.  With ``miss_first`` the
detector misses the object at frame 0, so map points are created on it and
the epipolar test has something to cull in the frames that follow.

The culling verdicts are not compared as counts between the packages: the
fundamental-matrix fit of stage 4 is ill-conditioned on this scene (see
``test_both_packages_cull_and_agree_on_poses``).  The rule that turns an F
into verdicts is held to JAX exactly, on JAX's own F: the JAX tracker is
traced afresh with ``jax.debug.callback`` taps on its stage-3 matches, its
fit's inputs and output and its epipolar distances, and the port's
``engine.tracker.cull_dynamic`` is fed what JAX fed its rule."""

import dataclasses

import jax
import numpy as np
import pytest

from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu.ops import epipolar as JE
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from stereo_semantic_vo_tpu_torch.ops import epipolar as TE
from tests.test_semantic_culling import OBJ_X, OBJ_Y0, render_with_mover
from tests.test_tracker import CFG, TX_STEP
from tests.torch_parity import n, one_torch_thread, rot_angle, t  # noqa: F401

N_FRAMES = 5
TCFG = interop.config_from_jax(CFG)
K, W = CFG.orb.max_keypoints, CFG.window.window_frames


def _port_run(cfg, n_frames, miss_first=False):
    state, outs = t_init_state(cfg, "cpu"), []
    for i in range(n_frames):
        frame = TT.FrameInput(*(t(a) for a in render_with_mover(i, detected=not (miss_first and i == 0))))
        state, out = (TT.init_step if i == 0 else TT.track_step)(state, frame, cfg)
        outs.append(out)
    return state, outs


def _jax_run_with_taps():
    """The JAX tracker on the mover scene with ``miss_first``; each tracked
    frame records stage 3's (matched, q_idx), the fit's (uv_last, uv,
    weight, F) and the epipolar distances, and the map_bad before and
    after the step."""
    taps = {"m3": [], "fit": [], "dd": []}

    def tap(name):
        return lambda *a: taps[name].append([np.asarray(x) for x in a])

    resolve, fit, dist = JT._resolve_matches, JE.fit_fundamental, JE.epipolar_distance
    traced = []

    def resolve_tapped(*a):
        out = resolve(*a)
        if not traced:  # stage 3 comes first; stage 5's call is not tapped
            traced.append(True)
            jax.debug.callback(tap("m3"), *out)
        return out

    def fit_tapped(uv1, uv2, w):
        F = fit(uv1, uv2, w)
        jax.debug.callback(tap("fit"), uv1, uv2, w, F)
        return F

    def dist_tapped(F, uv1, uv2):
        d = dist(F, uv1, uv2)
        jax.debug.callback(tap("dd"), d)
        return d

    # a fresh trace, so that the taps are in it whatever this process traced before
    step = jax.jit(JT.track_step.__wrapped__, static_argnames=("cfg",))
    state, outs, bad = j_init_state(CFG), [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "_resolve_matches", resolve_tapped)
        mp.setattr(JE, "fit_fundamental", fit_tapped)
        mp.setattr(JE, "epipolar_distance", dist_tapped)
        for i in range(N_FRAMES):
            frame = JT.FrameInput(*render_with_mover(i, detected=i != 0))
            before = np.asarray(state.map_bad)
            if i == 0:
                state, out = JT.init_step(state, frame, CFG)
            else:
                state, out = step(state, frame, cfg=CFG)
            jax.block_until_ready(out)
            jax.effects_barrier()
            outs.append(jax.tree.map(np.asarray, out))
            bad.append((before, np.asarray(state.map_bad)))
    assert all(len(v) == N_FRAMES - 1 for v in taps.values()), {k: len(v) for k, v in taps.items()}
    return outs, taps, bad


@pytest.fixture(scope="module")
def runs():
    j_outs, taps, bad = _jax_run_with_taps()
    _, t_outs = _port_run(TCFG, N_FRAMES, miss_first=True)
    return j_outs, taps, bad, t_outs


def test_no_map_point_created_in_the_padded_box():
    state, _ = _port_run(TCFG, 1)
    Xw, valid = n(state.map_Xw), n(state.map_valid)
    fx, cx, cy = CFG.camera.fx, CFG.camera.cx, CFG.camera.cy
    u = fx * Xw[:, 0] / np.maximum(Xw[:, 2], 1e-6) + cx
    v = fx * Xw[:, 1] / np.maximum(Xw[:, 2], 1e-6) + cy
    inside = (u > OBJ_X - 5) & (u < OBJ_X + 45) & (v > OBJ_Y0 - 5) & (v < OBJ_Y0 + 45)
    assert valid.sum() > 50 and not (inside & valid).any()


def test_dynamic_matches_culled_and_pose_clean(runs):
    t_outs = runs[3]
    assert sum(int(o.n_culled_dynamic) for o in t_outs[1:]) > 0, "the epipolar test never fired on the mover"
    for i, out in enumerate(t_outs):
        assert bool(out.pnp_ok)
        assert np.linalg.norm(n(out.T_wc)[:3, 3] - [i * TX_STEP, 0.0, 0.0]) < 0.08


def test_culling_disabled_when_semantics_off():
    _, outs = _port_run(dataclasses.replace(TCFG, use_semantics=False), 3)
    assert [int(o.n_culled_dynamic) for o in outs] == [0, 0, 0]


@pytest.mark.parametrize("frame", range(1, N_FRAMES))
def test_culling_rule_matches_jax_on_jax_F(runs, frame):
    """JAX's F, its matched uv, its stage-3 matches and the frame's boxes
    into the port's ``in_box_mask`` and ``cull_dynamic``: the in-box mask,
    the verdicts and the scattered map_bad equal JAX's; the distances agree
    to the float32 rounding of the line's terms (measured up to 2.5e-5 px;
    bound 1e-4 px, a thousandth of the 0.1 px threshold)."""
    j_outs, taps, bad, _ = runs
    (m3, q3), (uv_last, uv, w, F), (dd_j,) = (taps[k][frame - 1] for k in ("m3", "fit", "dd"))
    _, _, boxes, bv = render_with_mover(frame)
    mcfg = CFG.matcher
    in_box = TE.in_box_mask(t(uv), t(boxes), t(bv), mcfg.box_margin_match)
    in_box_j = np.asarray(JE.in_box_mask(uv, boxes, bv, mcfg.box_margin_match))
    np.testing.assert_array_equal(n(in_box), in_box_j)
    np.testing.assert_array_equal(w, (m3 & ~in_box_j).astype(np.float32))  # the fit saw the background

    # JAX's verdicts from its own distances, and its map_bad after the scatter:
    # the step's ring write replaces region t only, which no stage-3 slot lies in
    dynamic_j = m3 & in_box_j & (dd_j > mcfg.epipolar_threshold)
    assert int(dynamic_j.sum()) == int(j_outs[frame].n_culled_dynamic)
    before, after = bad[frame]
    region = slice((frame % W) * K, (frame % W + 1) * K)
    bad_j = after.copy()
    bad_j[region] = before[region]
    slot3 = ((frame - 1) % W) * K + q3.astype(np.int64)

    dynamic, map_bad = TT.cull_dynamic(t(F), t(uv_last), t(uv), t(m3), in_box, t(slot3), t(before), TCFG)
    np.testing.assert_array_equal(n(dynamic), dynamic_j)
    np.testing.assert_array_equal(n(map_bad), bad_j)
    dd = n(TE.epipolar_distance(t(F), t(uv_last), t(uv)))
    np.testing.assert_allclose(dd[m3], dd_j[m3], rtol=0, atol=1e-4)
    off, _ = TT.cull_dynamic(t(F), t(uv_last), t(uv), t(m3), in_box, t(slot3), t(before),
                             dataclasses.replace(TCFG, use_semantics=False))
    assert not bool(off.any())


def test_both_packages_cull_and_agree_on_poses(runs):
    """Both packages cull the mover, and their poses agree; which matches
    each culls at which frame is not compared.  At frame 1 the inputs to
    ``fit_fundamental`` are bit-identical in both packages (137 background
    weights), but the camera moves a few pixels a frame, so x2 ~ x1 and
    every near-skew-symmetric F almost fits: the normal matrix's smallest
    eigenvalue lies below float32 rounding.  JAX's float32 F and a float64
    fit differ by 1.08 in normalised max-abs, the port's by 0.35; the
    median background epipolar distance is 0.263 px under JAX's F, 0.006 px
    under the port's and 0.127 px under float64's, against the 0.1 px
    threshold.  So JAX culls 2 / 0 / 0 / 0 points at frames 1-4 and the
    port 0 / 2 / 2 / 0, while the poses agree within 3.0e-5 m."""
    j_outs, _, _, t_outs = runs
    assert sum(int(o.n_culled_dynamic) for o in j_outs) > 0
    assert sum(int(o.n_culled_dynamic) for o in t_outs) > 0
    for oj, ot in zip(j_outs, t_outs):
        Tj, Tt = oj.T_wc.astype(np.float64), n(ot.T_wc).astype(np.float64)
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
        assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
        assert bool(oj.pnp_ok) == bool(ot.pnp_ok)
