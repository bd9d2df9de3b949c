"""PyTorch port, the whole tracking slice against the JAX package.

Four frames of tests/test_tracker.py's renderer (240x320, K=256, 3 levels)
with VOConfig.kitti()'s knobs go through both packages' init_step /
track_step.  The JAX side is pinned to the kernels' contracts
(sparse_mode "strips", patch_backend "xla", matcher "popcount"); the port
runs "auto", which on the CPU is the plain version of each kernel.  Both
draw RANSAC's samples with JAX's threefry bits; the float sums run in other
orders, so poses are compared within 1e-3 m and 1e-3 rad per frame; frame-0
counters are exact, later ones within max(2, 2%)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core.config import VOConfig as JVO
from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from stereo_semantic_vo_tpu_torch.parallel.mesh import LANDMARK_AXIS, Mesh
from tests.test_tracker import CFG, TX_STEP, render
from tests.torch_parity import n, rot_angle, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4
COUNTERS = ("n_keypoints", "n_stereo", "n_matches_last", "n_matches_map", "n_pnp_inliers",
            "n_ba_inliers", "n_new_points", "n_culled_dynamic")


def _kitti_knobs():
    k = JVO.kitti()
    auto = dataclasses.replace(
        CFG,
        orb=dataclasses.replace(k.orb, max_keypoints=CFG.orb.max_keypoints, n_levels=CFG.orb.n_levels),
        matcher=k.matcher,
        pnp=dataclasses.replace(k.pnp, num_hypotheses=CFG.pnp.num_hypotheses),
        stereo=dataclasses.replace(k.stereo, max_disparity=CFG.stereo.max_disparity),
        ba=k.ba,
    )
    pinned = dataclasses.replace(
        auto,
        orb=dataclasses.replace(auto.orb, patch_backend="xla"),
        matcher=dataclasses.replace(auto.matcher, backend="popcount"),
        stereo=dataclasses.replace(auto.stereo, sparse_mode="strips"),
    )
    return pinned, interop.config_from_jax(auto)


def _boxes(n_boxes=8, with_box=False):
    boxes = np.zeros((n_boxes, 4), np.float32)
    valid = np.zeros(n_boxes, bool)
    if with_box:  # exercises the in-box culling and creation gates
        boxes[0] = [60, 130, 160, 220]
        valid[0] = True
    return boxes, valid


def _frame(i):
    left, right = (np.asarray(a) for a in render(i))
    return left, right, *_boxes(with_box=i == 2)


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg_t = _kitti_knobs()
    sj, st = j_init_state(cfg_j), t_init_state(cfg_t, "cpu")
    out_j, out_t, states_j = [], [], []
    for i in range(N_FRAMES):
        left, right, boxes, bv = _frame(i)
        fj = JT.FrameInput(*(jnp.asarray(a) for a in (left, right, boxes, bv)))
        ft = TT.FrameInput(*(t(a) for a in (left, right, boxes, bv)))
        sj, oj = (JT.init_step if i == 0 else JT.track_step)(sj, fj, cfg_j)
        st, ot = (TT.init_step if i == 0 else TT.track_step)(st, ft, cfg_t)
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
        states_j.append({k: np.asarray(v) for k, v in sj._asdict().items()})
    return cfg_j, cfg_t, out_j, out_t, states_j


def _axis_angle(axis, angle):
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


@pytest.mark.parametrize("angle", [1e-5, 3e-4, 0.5])
def test_rot_angle_reads_small_rotations_of_float32_poses(angle):
    """The pose checks' helper reads a rotation between two float32 poses
    to ~1e-7 rad; the arccos of the trace read 0 or 4.9e-4 rad at 1e-5."""
    rng = np.random.RandomState(7)
    for _ in range(20):
        Ra = _axis_angle(rng.normal(size=3), rng.uniform(0, np.pi))
        Rb = Ra @ _axis_angle(rng.normal(size=3), angle)
        a, b = Ra.astype(np.float32).astype(np.float64), Rb.astype(np.float32).astype(np.float64)
        assert abs(rot_angle(a.T @ b) - angle) <= 1e-6
        assert abs(rot_angle(_axis_angle(rng.normal(size=3), angle).astype(np.float32)) - angle) <= 1e-6


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_pose_matches_jax(runs, frame):
    _, _, out_j, out_t, _ = runs
    Tj, Tt = out_j[frame].T_wc.astype(np.float64), n(out_t[frame].T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
    assert bool(out_t[frame].pnp_ok) == bool(out_j[frame].pnp_ok)
    # and both track the ground truth, as tests/test_tracker.py requires
    assert np.linalg.norm(Tt[:3, 3] - [frame * TX_STEP, 0, 0]) < 0.05


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_counters_match_jax(runs, frame):
    _, _, out_j, out_t, _ = runs
    for name in COUNTERS:
        a, b = int(getattr(out_j[frame], name)), int(getattr(out_t[frame], name))
        tol = 0 if frame == 0 else max(2, int(0.02 * a))
        assert abs(a - b) <= tol, (name, a, b)
    if frame == 0:
        np.testing.assert_array_equal(n(out_t[0].obs_valid), out_j[0].obs_valid)
        np.testing.assert_array_equal(n(out_t[0].obs_uid), out_j[0].obs_uid)
        np.testing.assert_array_equal(n(out_t[0].kp_uv), out_j[0].kp_uv)


def test_port_resumes_from_jax_state(runs):
    """interop.state_from_numpy: the port continues the JAX package's state."""
    cfg_j, cfg_t, out_j, _, states_j = runs
    state = interop.state_from_numpy(states_j[1], "cpu")
    ft = TT.FrameInput(*(t(a) for a in _frame(2)))
    _, ot = TT.track_step(state, ft, cfg_t)
    Tj, Tt = out_j[2].T_wc, n(ot.T_wc)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert int(ot.n_matches_last) == int(out_j[2].n_matches_last)


def test_make_tracker_dispatches_init_then_track():
    _, cfg_t = _kitti_knobs()
    state, step = TT.make_tracker(cfg_t, device="cpu")
    for i in range(2):
        state, out = step(state, TT.FrameInput(*(t(a) for a in _frame(i))))
    assert int(state.frame_idx) == 1 and int(out.n_matches_last) > 30


def test_pipeline_on_cpu_writes_trajectories(tmp_path):
    _, cfg_t = _kitti_knobs()
    pipe = VOPipeline(cfg_t, device="cpu", out_dir=str(tmp_path))
    summary = pipe.run(((i, *_frame(i), 0.1 * i) for i in range(3)), prefetch=True)
    assert summary["n_frames"] == 3
    np.testing.assert_allclose(summary["positions"][:, 0], np.arange(3) * TX_STEP, atol=0.05)
    for name in ("cameratrajectory_kitti.txt", "cameratrajectory_tum.txt"):
        assert len(open(tmp_path / name).read().strip().split("\n")) == 3


@pytest.mark.parametrize("kwargs", [{"ba_mesh": Mesh((torch.device("meta"),), (LANDMARK_AXIS,)), "local_ba_every": 1}])
def test_pipeline_unported_arguments_raise(kwargs):
    """``ba_mesh``, refused until the sharded window BA was ported, is
    taken now (tests/test_torch_sharded_ba.py); a mesh whose rank runs on
    another device than the pipeline is refused."""
    with pytest.raises(ValueError, match="the mesh's rank runs on meta, the pipeline on cpu"):
        VOPipeline(_kitti_knobs()[1], device="cpu", **kwargs)


def test_cli_without_a_card_exits_naming_the_device(tmp_path):
    """The default --device cuda never falls back to the CPU: on a machine
    without a CUDA device the CLI exits before it reads a frame."""
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from stereo_semantic_vo_tpu_torch import run\n"
        f"sys.argv = ['run', '--sequence', {str(tmp_path / 'missing')!r}]\n"
        "run.main()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0 and "no CUDA device" in out.stderr and "--device cuda" in out.stderr
