"""PyTorch port, the JAX package's default configuration through the whole
tracking slice.

tests/test_tracker.py's ``CFG`` is ``VOConfig(...)`` with the defaults of
every section it does not set: steered BRIEF (``steer=True``), sparse
stereo "strips", the popcount matcher, the einsum BA builds.  Four frames
of its renderer (240x320, K=256, 3 levels) go through both packages'
init_step / track_step.  Both draw RANSAC's samples with JAX's threefry
bits; the float sums run in other orders, so poses are compared within
1e-3 m and 1e-3 rad per frame; frame-0 counters are exact, later ones within max(2, 2%); frame 0's
keypoints and bindings exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from tests.test_tracker import CFG, TX_STEP, empty_boxes, render
from tests.torch_parity import n, rot_angle, t, one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES = 4
COUNTERS = ("n_keypoints", "n_stereo", "n_matches_last", "n_matches_map", "n_pnp_inliers",
            "n_ba_inliers", "n_new_points", "n_culled_dynamic")


@pytest.fixture(scope="module")
def runs():
    cfg_t = interop.config_from_jax(CFG)
    assert cfg_t.orb.steer and cfg_t.stereo.sparse_mode == "strips"
    boxes, bv = (np.asarray(a) for a in empty_boxes())
    sj, st = j_init_state(CFG), t_init_state(cfg_t, "cpu")
    out_j, out_t = [], []
    for i in range(N_FRAMES):
        left, right = (np.asarray(a) for a in render(i))
        fj = JT.FrameInput(*(jnp.asarray(a) for a in (left, right, boxes, bv)))
        ft = TT.FrameInput(*(t(a) for a in (left, right, boxes, bv)))
        sj, oj = (JT.init_step if i == 0 else JT.track_step)(sj, fj, CFG)
        st, ot = (TT.init_step if i == 0 else TT.track_step)(st, ft, cfg_t)
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
    return out_j, out_t


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_pose_matches_jax(runs, frame):
    out_j, out_t = runs
    Tj, Tt = out_j[frame].T_wc.astype(np.float64), n(out_t[frame].T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
    assert bool(out_t[frame].pnp_ok) == bool(out_j[frame].pnp_ok)
    assert np.linalg.norm(Tt[:3, 3] - [frame * TX_STEP, 0, 0]) < 0.05


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_counters_match_jax(runs, frame):
    out_j, out_t = runs
    for name in COUNTERS:
        a, b = int(getattr(out_j[frame], name)), int(getattr(out_t[frame], name))
        tol = 0 if frame == 0 else max(2, int(0.02 * a))
        assert abs(a - b) <= tol, (name, a, b)
    if frame == 0:
        for name in ("obs_valid", "obs_uid", "kp_uv"):
            np.testing.assert_array_equal(n(getattr(out_t[0], name)), getattr(out_j[0], name), err_msg=name)
