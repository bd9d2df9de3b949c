"""PyTorch port, the dense-stereo tracking path (``sparse_mode="dense"``)
against the JAX package, and the CLI's ``--dense-stereo --local-ba 1``.

Four frames of tests/test_tracker.py's renderer (240x320, K=256, 3 levels)
with ``VOConfig.kitti()``'s knobs and dense stereo go through both packages'
init_step / track_step.  The JAX side aggregates with its plain scan
("xla"); the port runs "auto", which on the CPU is the SGM kernel's plain
version.  Tolerances are test_torch_slice.py's: poses within 1e-3 m and
1e-3 rad per frame; counters within max(2, 2%) (frame 0 included here: the
dense disparity differs from JAX's in the last bit of the edge-aware P2
planes, so a keypoint on a near-tie may flip).

No frame carries a detection box.  On this scene (pure sideways motion past
two fronto-parallel planes) the 8-point normal matrix of the epipolar test
has its smallest eigenvalue below the float32 rounding of its entries, so
the fitted F, and with it the in-box culling verdicts, differ between any
two summation orders (ROADMAP C); test_torch_slice.py covers culling."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from tests.test_torch_slice import COUNTERS, _boxes, _kitti_knobs
from tests.test_tracker import TX_STEP, render
from tests.torch_parity import n, rot_angle, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4


def _dense(cfg, backend):
    return dataclasses.replace(cfg, stereo=dataclasses.replace(cfg.stereo, sparse_mode="dense", dense_backend=backend))


@pytest.fixture(scope="module")
def runs():
    pinned, auto = _kitti_knobs()
    cfg_j, cfg_t = _dense(pinned, "xla"), _dense(auto, "auto")
    sj, st = j_init_state(cfg_j), t_init_state(cfg_t, "cpu")
    out_j, out_t = [], []
    boxes, bv = _boxes()
    for i in range(N_FRAMES):
        left, right = (np.asarray(a) for a in render(i))
        fj = JT.FrameInput(*(jnp.asarray(a) for a in (left, right, boxes, bv)))
        ft = TT.FrameInput(*(t(a) for a in (left, right, boxes, bv)))
        sj, oj = (JT.init_step if i == 0 else JT.track_step)(sj, fj, cfg_j)
        st, ot = (TT.init_step if i == 0 else TT.track_step)(st, ft, cfg_t)
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
    return out_j, out_t


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_dense_track_step_matches_jax(runs, frame):
    out_j, out_t = runs
    Tj, Tt = out_j[frame].T_wc.astype(np.float64), n(out_t[frame].T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
    assert bool(out_t[frame].pnp_ok) == bool(out_j[frame].pnp_ok)
    assert np.linalg.norm(Tt[:3, 3] - [frame * TX_STEP, 0, 0]) < 0.05
    for name in COUNTERS:
        a, b = int(getattr(out_j[frame], name)), int(getattr(out_t[frame], name))
        assert abs(a - b) <= max(2, int(0.02 * a)), (name, a, b)
    assert int(out_t[frame].n_stereo) > 50  # the dense disparity feeds the map


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A KITTI-layout sequence of the renderer's frames (tests/test_cli.py)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dense_seq")
    for side in ("image_2", "image_3"):
        os.makedirs(root / side)
    n_frames = 5
    for i in range(n_frames):
        for side, img in zip(("image_2", "image_3"), render(i)):
            Image.fromarray(np.asarray(img).astype(np.uint8)).save(root / side / f"{i:06d}.png")
    np.savetxt(root / "times.txt", np.arange(n_frames) * 0.1)
    return str(root)


def test_cli_dense_stereo_local_ba_writes_trajectories(sequence, tmp_path):
    """The full-size KITTI config on the small frames: this checks the
    plumbing (flags, dense stereo, two window refines, trajectory files)."""
    out = subprocess.run(
        [sys.executable, "-m", "stereo_semantic_vo_tpu_torch.run", "--sequence", sequence,
         "--out", str(tmp_path / "out"), "--dense-stereo", "--local-ba", "1", "--max-frames", "5", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["n_frames"] == 5 and report["device"] == "cpu"
    for name in ("cameratrajectory_kitti.txt", "cameratrajectory_tum.txt"):
        lines = open(tmp_path / "out" / name).read().strip().split("\n")
        assert len(lines) == 5
        assert np.isfinite(np.loadtxt(tmp_path / "out" / name)).all()
