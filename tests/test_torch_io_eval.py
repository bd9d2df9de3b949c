"""PyTorch port, the output path against the JAX package: the offline box
files and the KITTI sequence reader (io/kitti.py), the trajectory lines,
writer and reader (engine/trajectory.py), the trajectory metrics
(eval/ate.py), and ``run.py`` in this process with offline boxes, a
ground-truth file and ``--no-semantics`` (its report's ``stage_device_ms``
from the tracer included).

Inputs are made with numpy from a seed.  Lines and files are compared as
strings and bytes, arrays exactly, the metrics (float64 numpy in both
packages) to 1e-12."""

import json
import os
import sys

import numpy as np
import pytest

from stereo_semantic_vo_tpu.engine import trajectory as JTR
from stereo_semantic_vo_tpu.eval import ate as JA
from stereo_semantic_vo_tpu.io import kitti as JK
from stereo_semantic_vo_tpu_torch.engine import trajectory as TTR
from stereo_semantic_vo_tpu_torch.eval import ate as TA
from stereo_semantic_vo_tpu_torch.io import kitti as TK
from tests.test_semantic_culling import render_with_mover
from tests.test_tracker import TX_STEP
from tests.torch_parity import one_torch_thread  # noqa: F401

N_SEQ_FRAMES = 3


def _axis_angle(axis, angle):
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def _rigid(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _walk(n, seed):
    """A driving-like trajectory: 0.3-0.7 m a frame forward with small turns."""
    rng = np.random.RandomState(seed)
    poses = [np.eye(4)]
    for _ in range(n - 1):
        step = _rigid(_axis_angle(rng.normal(size=3), rng.uniform(0, 0.02)), [*rng.normal(0, 0.05, 2), rng.uniform(0.3, 0.7)])
        poses.append(poses[-1] @ step)
    return np.stack(poses)


def _poses(n=60, seed=0):
    """Random rigid poses: every branch of the quaternion conversion (a
    positive trace and each diagonal entry largest), metres to kilometres."""
    rng = np.random.RandomState(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        out[i, :3, :3] = _axis_angle(rng.normal(size=3), rng.uniform(0, np.pi))
        out[i, :3, 3] = rng.normal(size=3) * 10.0 ** rng.uniform(-2, 3)
    return out


def test_kitti_and_tum_lines_equal_jax():
    rng = np.random.RandomState(1)
    for T in _poses():
        ts = float(rng.uniform(0, 1e3))
        assert TTR.kitti_line(T) == JTR.kitti_line(T)
        assert TTR.tum_line(ts, T) == JTR.tum_line(ts, T)


def test_writer_and_reader_round_trip_equal_jax(tmp_path):
    poses = _poses(20, seed=2)
    files = {}
    for name, mod in (("jax", JTR), ("port", TTR)):
        k, t = str(tmp_path / f"{name}_kitti.txt"), str(tmp_path / f"{name}_tum.txt")
        w = mod.TrajectoryWriter(k, t)
        for i, T in enumerate(poses):
            w.append(T, 0.1037 * i)
        w.close()
        np.testing.assert_array_equal(w.positions(), poses[:, :3, 3])
        files[name] = (k, t)
    for a, b in zip(files["jax"], files["port"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    back_j, back_t = JTR.load_kitti_poses(files["jax"][0]), TTR.load_kitti_poses(files["port"][0])
    np.testing.assert_array_equal(back_t, back_j)
    assert back_t.shape == (20, 4, 4)
    np.testing.assert_allclose(back_t, poses, rtol=0, atol=5e-10 * max(1.0, np.abs(poses).max()))


BOX_FILES = {
    # the reference's rows: left right top bottom
    "reference_order": "10 50 20 40\n",
    "more_rows_than_max_boxes": "".join(f"{i} {i + 30} {2 * i} {2 * i + 40}\n" for i in range(11)),
    "short_rows": "1 2 3\n\n5 6 7 8 0.93 car\n9\n11 12 13 14\n",
    "missing": None,
}


@pytest.mark.parametrize("case", BOX_FILES)
def test_offline_boxes_equal_jax(tmp_path, case):
    path = str(tmp_path / "1.txt")
    if BOX_FILES[case] is not None:
        with open(path, "w") as f:
            f.write(BOX_FILES[case])
    got, want = TK.load_offline_boxes(path, 8), JK.load_offline_boxes(path, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    boxes, valid = got
    if case == "reference_order":
        np.testing.assert_array_equal(boxes[0], [10, 20, 50, 40])  # [x1, y1, x2, y2]
        assert valid.tolist() == [True] + [False] * 7
    elif case == "more_rows_than_max_boxes":
        assert valid.all() and boxes[7].tolist() == [7, 14, 37, 54]
    elif case == "short_rows":
        assert valid.sum() == 2 and boxes[1].tolist() == [11, 13, 12, 14]
    else:
        assert not valid.any() and not boxes.any()


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """tests/test_semantic_culling.py's mover frames as a KITTI sequence:
    8-bit PNGs, times.txt, the mover's box in the reference's files
    (``<frame+1>.txt``, none for frame 1: a missed detection) and a KITTI
    ground-truth pose file."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mover_seq")
    for d in ("image_2", "image_3", "boxes"):
        os.makedirs(root / d)
    gt = []
    for i in range(N_SEQ_FRAMES):
        left, right, boxes, valid = (np.asarray(a) for a in render_with_mover(i))
        for side, img in (("image_2", left), ("image_3", right)):
            Image.fromarray(img.astype(np.uint8)).save(root / side / f"{i:06d}.png")
        if i != 1:
            x1, y1, x2, y2 = (int(v) for v in boxes[valid][0])
            (root / "boxes" / f"{i + 1}.txt").write_text(f"{x1} {x2} {y1} {y2}\n")
        T = np.eye(4)
        T[0, 3] = i * TX_STEP
        gt.append(JTR.kitti_line(T))
    np.savetxt(root / "times.txt", np.arange(N_SEQ_FRAMES) * 0.1)
    (root / "gt.txt").write_text("\n".join(gt) + "\n")
    return root


def test_iter_frames_equal_jax(sequence):
    """Frames, boxes and timestamps in order; a missing box file is no box."""
    tp, jp = TK.load_sequence_paths(str(sequence)), JK.load_sequence_paths(str(sequence))
    assert tp.left == jp.left and tp.right == jp.right and np.array_equal(tp.timestamps, jp.timestamps)
    got = list(TK.iter_frames(tp, str(sequence / "boxes"), 8, use_native=False))
    want = list(JK.iter_frames(jp, str(sequence / "boxes"), 8, use_native=False))
    assert [g[0] for g in got] == list(range(N_SEQ_FRAMES))
    for g, w in zip(got, want):
        for a, b in zip(g[1:5], w[1:5]):
            np.testing.assert_array_equal(a, b)
        assert g[5] == w[5]
    assert [bool(g[4].any()) for g in got] == [True, False, True]


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_alignment_matches_jax(with_scale):
    rng = np.random.RandomState(4)
    pts = rng.uniform(-5, 5, (60, 3))
    moved = 1.3 * pts @ _axis_angle([0.3, -0.2, 0.5], 0.7).T + [1.0, 2.0, 3.0] + rng.normal(0, 0.05, pts.shape)
    for g, w in zip(TA.umeyama_alignment(pts, moved, with_scale), JA.umeyama_alignment(pts, moved, with_scale)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_matches_jax(align):
    p = _walk(30, seed=5)
    q = p.copy()
    q[:, :3, 3] += np.random.RandomState(6).normal(0, 0.1, (30, 3))
    q = np.einsum("ij,njk->nik", _rigid(_axis_angle([1, 2, 3], 0.2), [4.0, -1.0, 2.0]), q)
    assert abs(TA.ate_rmse(q, p, align=align) - JA.ate_rmse(q, p, align=align)) <= 1e-12
    assert abs(TA.ate_rmse(q[:2], p[:2]) - JA.ate_rmse(q[:2], p[:2])) <= 1e-12  # too short to align


@pytest.mark.parametrize("delta", [1, 4])
def test_rpe_matches_jax(delta):
    p = _walk(25, seed=7)
    q = p @ np.stack([_rigid(_axis_angle(r[:3], 0.01 * r[3]), 0.02 * r[4:]) for r in np.random.RandomState(8).normal(size=(25, 7))])
    for g, w in zip(TA.rpe(q, p, delta), JA.rpe(q, p, delta)):
        assert abs(g - w) <= 1e-12


def _straight(n, scale=1.0):
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 2, 3] = np.arange(n, dtype=float) * scale
    return poses


def _drifted(gt):
    """``gt`` with a 1% scale drift, a yaw growing 1e-4 rad a frame and
    position noise -> (est, gt)."""
    est = gt.copy()
    est[:, :3, 3] = 1.01 * gt[:, :3, 3] + np.random.RandomState(11).normal(0, 0.05, (len(gt), 3))
    est[:, :3, :3] = np.stack([R @ _axis_angle([0, 1, 0], 1e-4 * i) for i, R in enumerate(gt[:, :3, :3])])
    return est, gt


SEGMENT_CASES = {
    "perfect": lambda: (_straight(900), _straight(900)),
    "scale_drift": lambda: (_straight(900, 1.02), _straight(900)),
    "turning_noisy": lambda: _drifted(_walk(900, seed=9)),
    "too_short": lambda: (_straight(10), _straight(10)),
}


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_kitti_segment_errors_match_jax(case):
    est, gt = SEGMENT_CASES[case]()
    got, want = TA.kitti_segment_errors(est, gt), JA.kitti_segment_errors(est, gt)
    if case == "too_short":
        assert all(np.isnan(v) for v in got + want)
        return
    for g, w in zip(got, want):
        assert np.isfinite(g) and abs(g - w) <= 1e-12 * max(1.0, abs(w))


def test_run_main_in_process_no_semantics(sequence, tmp_path, monkeypatch, capsys):
    """``run.main()`` with ``--device cpu --boxes-dir --gt --no-semantics``:
    the report's keys, no point culled, both trajectory files, and
    ``ate_rmse_m`` equal to JAX's ``ate_rmse`` on the written file.  The
    frames decode at their own 320x240 on Pillow: the native loader would
    zero-pad them to the KITTI config's 1241x376 and make the run a
    full-size one."""
    from stereo_semantic_vo_tpu_torch import run
    from stereo_semantic_vo_tpu_torch.io import native_loader

    monkeypatch.setattr(native_loader, "available", lambda: False)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "run", "--sequence", str(sequence), "--boxes-dir", str(sequence / "boxes"), "--gt", str(sequence / "gt.txt"),
        "--no-semantics", "--out", str(out), "--device", "cpu"])
    run.main()
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"n_frames", "median_s", "mean_s", "fps", "device", "n_culled_dynamic",
                           "kernel_launches", "stage_device_ms", "ate_rmse_m"}
    # the tracer's stages, on the CPU's clock: the init and track steps' own
    assert set(report["stage_device_ms"]) == {"orb", "stereo", "match", "pnp", "lm", "map"}
    assert all(ms > 0.0 for ms in report["stage_device_ms"].values())
    assert report["n_frames"] == N_SEQ_FRAMES and report["device"] == "cpu"
    assert report["n_culled_dynamic"] == [0] * N_SEQ_FRAMES
    assert set(report["kernel_launches"].values()) == {0}  # the CPU runs the plain versions
    est = JTR.load_kitti_poses(str(out / "cameratrajectory_kitti.txt"))
    assert est.shape == (N_SEQ_FRAMES, 4, 4) and np.isfinite(est).all()
    tum = np.loadtxt(out / "cameratrajectory_tum.txt")
    assert tum.shape == (N_SEQ_FRAMES, 8)
    np.testing.assert_allclose(tum[:, 0], np.arange(N_SEQ_FRAMES) * 0.1, atol=1e-6)
    want = JA.ate_rmse(est, JTR.load_kitti_poses(str(sequence / "gt.txt"))[:N_SEQ_FRAMES])
    assert report["ate_rmse_m"] == want
