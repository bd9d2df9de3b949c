"""PyTorch port, the online-detection path against the JAX package, on the CPU.

Both packages' ``VOPipeline`` run four frames of tests/test_tracker.py's
renderer with ``zoo.kitti_tiny_v2(conf_threshold=0.01)`` on the same
random params, under test_torch_slice.py's config (``VOConfig.kitti()``'s
knobs at the renderer's size, upright ORB), with ``async_detect`` True
(frame t tracks with frame t-1's boxes) and False (with its own).  RANSAC
draws differ between the packages, so poses are held within 1e-3 m and
1e-3 rad per frame; the pending detections, and the boxes each frame's
step is given, against the JAX detector's within 1e-2 px, valid equal.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.engine.pipeline import VOPipeline as JPipeline
from stereo_semantic_vo_tpu.models import zoo as JZ
from stereo_semantic_vo_tpu_torch.engine import graphs as TG
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline as TPipeline
from stereo_semantic_vo_tpu_torch.models import yolo as TY
from stereo_semantic_vo_tpu_torch.models import zoo as TZ
from tests.test_torch_slice import _kitti_knobs
from tests.test_tracker import TX_STEP, render
from tests.torch_parity import n, rot_angle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4
POS_TOL_M, ROT_TOL_RAD = 1e-3, 1e-3
BOX_TOL_PX = 1e-2
CONF = 0.01

# a 96x96 two-block region net: the CLI and plumbing tests' small detector
YOLO_CFG = """
[net]
width=96
height=96
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
size=1
stride=1
pad=1
filters=30
activation=linear

[region]
anchors = 0.5,0.8, 1.0,1.5, 1.2,2.0, 1.5,3.0, 2.5,4.5
classes=1
num=5
softmax=1
"""


def _frames():
    return [tuple(np.array(a) for a in render(i)) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def detectors():
    jdet = JZ.kitti_tiny_v2(conf_threshold=CONF)
    tdet = TY.YoloDetector.from_params(TZ.KITTI_TINY_V2_CFG, jdet.params, conf_threshold=CONF, device="cpu")
    return jdet, tdet


@pytest.fixture(scope="module")
def jax_boxes(detectors):
    """The JAX detector's (boxes, valid) on each frame."""
    jdet, _ = detectors
    out = []
    for left, _ in _frames():
        det = jdet.detect(jnp.asarray(left) / 255.0)
        out.append((np.asarray(det.boxes), np.asarray(det.valid)))
    return out


def _run(pipe, frames):
    """-> (poses, the pending detections after each frame, the (boxes,
    valid) each frame's step was given); the last is recorded for the
    port's pipeline only."""
    pending, seen = [], []

    def recorder(step):
        def wrapped(state, frame, cfg):
            seen.append((n(frame.boxes).copy(), n(frame.boxes_valid).copy()))
            return step(state, frame, cfg)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TG, "init_step", recorder(TG.init_step))
        mp.setattr(TG, "track_step", recorder(TG.track_step))
        for i, (left, right) in enumerate(frames):
            pipe.process_frame(left, right, None, None, 0.1 * i)
            if pipe._det_pending is not None:
                pending.append(tuple(n(x).copy() for x in pipe._det_pending))
        pipe.flush()
    return np.stack([n(o.T_wc) for o in pipe.outputs]).astype(np.float64), pending, seen


@pytest.fixture(scope="module", params=[True, False], ids=["async", "sync"])
def runs(request, detectors):
    jdet, tdet = detectors
    cfg_j, cfg_t = _kitti_knobs()
    frames = _frames()
    jp = JPipeline(cfg_j, detector=jdet, write_trajectory=False, async_detect=request.param)
    tp = TPipeline(cfg_t, device="cpu", detector=tdet, write_trajectory=False, async_detect=request.param)
    return request.param, _run(jp, frames)[0], *_run(tp, frames), tp


def test_poses_match_jax(runs):
    _, pj, pt, _, _, pipe = runs
    for Tj, Tt in zip(pj, pt):
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= POS_TOL_M
        assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= ROT_TOL_RAD
    np.testing.assert_allclose(pt[:, 0, 3], np.arange(N_FRAMES) * TX_STEP, atol=0.05)
    assert all(bool(o.pnp_ok) for o in pipe.outputs[1:])


def _assert_boxes_close(got, want):
    (bt, vt), (bj, vj) = got, want
    assert bt.shape == bj.shape and vt.shape == vj.shape and vt.dtype == bool
    np.testing.assert_array_equal(vt, vj)
    assert vt.any()
    np.testing.assert_allclose(bt[vt], bj[vj], rtol=0, atol=BOX_TOL_PX)


def test_pending_detections_match_jax(runs, jax_boxes):
    is_async, _, _, pending, _, pipe = runs
    if not is_async:
        assert pipe._det_pending is None and not pending  # the synchronous mode keeps nothing pending
        return
    assert len(pending) == N_FRAMES
    for got, want in zip(pending, jax_boxes):
        _assert_boxes_close(got, want)


def test_async_frame_sees_the_previous_frames_boxes(runs, jax_boxes):
    """With ``async_detect`` frame t's step gets the detections of frame
    t-1, frame 0 none; without, frame t's own (JAX's detections of each
    frame as the reference)."""
    is_async, _, _, _, seen, _ = runs
    assert len(seen) == N_FRAMES
    if is_async:
        assert not seen[0][1].any() and not seen[0][0].any()
        want = jax_boxes[:-1]
        seen = seen[1:]
    else:
        want = jax_boxes
    for got, w in zip(seen, want):
        _assert_boxes_close(got, w)


@pytest.mark.parametrize("max_boxes", [8, 32, 40])
def test_detections_are_cut_or_padded_to_max_boxes(max_boxes):
    import dataclasses

    cfg = _kitti_knobs()[1]
    pipe = TPipeline(dataclasses.replace(cfg, semantic=dataclasses.replace(cfg.semantic, max_boxes=max_boxes)),
                     device="cpu", write_trajectory=False)
    boxes = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
    valid = torch.arange(32) % 3 == 0
    b, v = pipe._fit_boxes(boxes, valid)
    assert b.shape == (max_boxes, 4) and v.shape == (max_boxes,) and v.dtype == torch.bool
    k = min(32, max_boxes)
    assert torch.equal(b[:k], boxes[:k]) and torch.equal(v[:k], valid[:k])
    assert not b[k:].any() and not v[k:].any()


def test_run_drops_offline_boxes_with_a_detector(monkeypatch):
    tdet = TY.YoloDetector(YOLO_CFG, conf_threshold=CONF, device="cpu")
    seen = []
    step = TG.init_step

    def init_step(state, frame, cfg):
        seen.append(frame.boxes_valid.clone())
        return step(state, frame, cfg)

    monkeypatch.setattr(TG, "init_step", init_step)
    left, right = _frames()[0]
    offline = (0, left, right, np.ones((32, 4), np.float32), np.ones(32, bool), 0.0)
    TPipeline(_kitti_knobs()[1], device="cpu", detector=tdet, write_trajectory=False).run([offline], prefetch=False)
    assert len(seen) == 1 and not seen[0].any()  # frame 0 tracks with no boxes, not the offline ones


def test_detector_on_another_device_is_refused():
    """No silent move: a detector on another device than the pipeline's."""

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="detector runs on meta"):
        TPipeline(_kitti_knobs()[1], device="cpu", detector=Elsewhere())




@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A KITTI-layout sequence of the renderer's frames, as in tests/test_cli.py."""
    from PIL import Image

    root = tmp_path_factory.mktemp("online_seq")
    for side in ("image_2", "image_3"):
        os.makedirs(root / side)
    for i, pair in enumerate(_frames()[:3]):
        for side, img in zip(("image_2", "image_3"), pair):
            Image.fromarray(img.astype(np.uint8)).save(root / side / f"{i:06d}.png")
    np.savetxt(root / "times.txt", np.arange(3) * 0.1)
    (root / "tiny.cfg").write_text(YOLO_CFG)
    return root


@pytest.mark.parametrize("with_weights", [False, True])
def test_cli_online_detection_writes_trajectories(sequence, tmp_path, with_weights):
    """``run.py --device cpu --yolo-cfg`` (random weights, or a darknet
    .weights file) on the full-size KITTI config: the plumbing, not accuracy."""
    from stereo_semantic_vo_tpu_torch.io import darknet

    flags = ["--yolo-cfg", str(sequence / "tiny.cfg")]
    if with_weights:
        sections = darknet.parse_cfg(YOLO_CFG)
        (tmp_path / "tiny.weights").write_bytes(
            darknet.save_weights_raw(sections, darknet.random_weights_raw(sections, 1)))
        flags += ["--yolo-weights", str(tmp_path / "tiny.weights")]
    out = subprocess.run(
        [sys.executable, "-m", "stereo_semantic_vo_tpu_torch.run", "--sequence", str(sequence),
         "--out", str(tmp_path / "out"), "--max-frames", "2", "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"n_frames": 2' in out.stdout
    for name in ("cameratrajectory_kitti.txt", "cameratrajectory_tum.txt"):
        assert len((tmp_path / "out" / name).read_text().strip().split("\n")) == 2
