"""PyTorch port, the tracking slice with its two kernel knobs on
(``orb.fast_backend="pallas"``, ``ba.hessian_backend="pallas"``) against
the JAX package with the same knobs.

Four frames of tests/test_tracker.py's renderer (240x320, K=256, 3 levels)
with VOConfig.kitti()'s knobs, as test_torch_slice.py runs them.  JAX runs
its FAST and motion-BA Pallas kernels in interpret mode; the port runs
their plain versions on the CPU (kernels/fast_score.py,
kernels/ba_hessian.py).  Poses are compared within 1e-3 m and 1e-3 rad
per frame, as in test_torch_slice.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from tests.test_torch_slice import _frame, _kitti_knobs
from tests.test_tracker import TX_STEP
from tests.torch_parity import n, rot_angle, t

N_FRAMES = 4


def _knobs_on(cfg):
    return dataclasses.replace(
        cfg,
        orb=dataclasses.replace(cfg.orb, fast_backend="pallas"),
        ba=dataclasses.replace(cfg.ba, hessian_backend="pallas"),
    )


@pytest.fixture(scope="module")
def runs():
    pinned, auto = _kitti_knobs()
    cfg_j, cfg_t = _knobs_on(pinned), _knobs_on(auto)
    sj, st = j_init_state(cfg_j), t_init_state(cfg_t, "cpu")
    out_j, out_t = [], []
    for i in range(N_FRAMES):
        arrays = _frame(i)
        fj = JT.FrameInput(*(jnp.asarray(a) for a in arrays))
        ft = TT.FrameInput(*(t(a) for a in arrays))
        sj, oj = (JT.init_step if i == 0 else JT.track_step)(sj, fj, cfg_j)
        st, ot = (TT.init_step if i == 0 else TT.track_step)(st, ft, cfg_t)
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
    return out_j, out_t


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_knob_path_pose_matches_jax(runs, frame):
    out_j, out_t = runs
    Tj, Tt = out_j[frame].T_wc.astype(np.float64), n(out_t[frame].T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
    assert bool(out_t[frame].pnp_ok) == bool(out_j[frame].pnp_ok)
    assert np.linalg.norm(Tt[:3, 3] - [frame * TX_STEP, 0, 0]) < 0.05
    if frame == 0:  # FAST is bit-equal, so frame 0's keypoints are too
        np.testing.assert_array_equal(n(out_t[0].kp_uv), out_j[0].kp_uv)
