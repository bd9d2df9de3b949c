"""PyTorch port of the YOLO trainer's steps against the JAX package, on the CPU.

The gradient of every leaf against ``jax.grad`` through both test cfgs of
test_torch_yolo_train.py (constant image regions: max-pool ties); then
``YoloTrainer`` of both packages from the same raw params on the JAX
tests' ``TRAIN_CFG`` (burn-in off, lr 0.003, so that the steps move the
params), then the port resumed from the JAX trainer's state; the weights
export; the JAX overfit test on the port; the replay-training tool's pieces
against the repository's ``tools/train_replay_detector.py``.  Tolerances:
- gradients of every leaf: atol 1e-4 x max|JAX| per leaf (measured 2e-5:
  the forward's rounding differences, carried back through every layer);
- at full width (kitti_tiny_v2, 352x352), the port's float32 gradients
  against its float64 ones: 7.5e-3 of each leaf's L2 norm;
- 3 train steps: loss rtol 1e-4; params, rolling statistics and momentum
  atol 1e-4 x max|JAX| per leaf (float32 sums in another order, carried
  through 3 updates); ``batch_num`` and ``seen`` exact;
- the train state through ``interop`` and back: equal;
- ``export_weights`` before any step: bytes equal;
- the folded detector against the one loaded from the exported blob: valid
  equal, boxes 1e-3 px;
- the tool's ``to_net``: 1e-5 (the letterbox's antialiased resize of two
  libraries, as tests/test_torch_yolo.py holds it); ``boxes_to_truths`` and
  ``iou_xyxy``: equal.
"""

import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.io import darknet as JD
from stereo_semantic_vo_tpu.models import yolo_train as JT
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.models import yolo as TY
from stereo_semantic_vo_tpu_torch.models import yolo_train as TT
from stereo_semantic_vo_tpu_torch.tools import train_replay_detector as TOOL
from tests.test_torch_yolo_train import _COLLIDE, _YOLO_CASES, CFGS, YOLO_CFG, _close, _images, _nchw, _raw, _truths
from tests.test_yolo_train import TRAIN_CFG
from tests.torch_parity import n, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_ATOL_REL = 1e-4
STEP_LOSS_RTOL, STEP_ATOL_REL = 1e-4, 1e-4
BOX_TOL_PX = 1e-3
TO_NET_TOL = 1e-5

@pytest.mark.parametrize("which", ["region", "yolo"])
def test_leaf_gradients_match_jax_grad(which):
    cfg = CFGS[which]
    secs = JD.parse_cfg(cfg)
    raw = _raw(cfg, stats=True)
    x = _images()
    t, m = _truths(_COLLIDE if which == "region" else _YOLO_CASES["mixed"], 8)

    def jloss(params):
        heads, _ = JT.forward_train(params, secs, jnp.asarray(x), train=True)
        total = 0.0
        for sec, feat in heads:
            if sec["type"] == "region":
                total = total + JT.region_loss(feat, sec, jnp.asarray(t), jnp.asarray(m), seen=0).loss
            else:
                total = total + JT.yolo_loss(feat, sec, jnp.asarray(t), jnp.asarray(m), 64, 64).loss
        return total

    g_j = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, raw))
    trainer = TT.YoloTrainer(cfg, device="cpu")
    trainer.load_state(interop.train_state_from_numpy(
        raw, {li: {k: np.zeros_like(v) for k, v in p.items() if k in TT.TRAINABLE} for li, p in raw.items()},
        0, 0, "cpu"))
    leaves = trainer.net.trainable()
    loss, _, _ = trainer.loss(_nchw(x), torch.from_numpy(t), torch.from_numpy(m))
    grads = torch.autograd.grad(loss, [p for _, _, p in leaves])
    for (li, k, _), g in zip(leaves, grads):
        a = n(g)
        if k == "w":
            a = np.transpose(a, (2, 3, 1, 0))
        _close(a, g_j[li][k], 0, GRAD_ATOL_REL, f"layer {li} {k}")



STEP_CFG = TRAIN_CFG.replace("burn_in=100", "burn_in=0").replace("learning_rate=0.001", "learning_rate=0.003")


@pytest.fixture(scope="module")
def three_steps():
    """Both trainers from the same raw params: 3 steps; then the port from
    the JAX trainer's state after those steps (momentum live): 3 more."""
    x = _images()
    batches = [(x[::-1].copy() if s % 2 else x, *_truths(_COLLIDE, 8)) for s in range(6)]
    jtr = JT.YoloTrainer(STEP_CFG, seed=5)
    ttr = TT.YoloTrainer(STEP_CFG, seed=5, device="cpu")
    runs = {"raw": [], "resumed": []}
    for s, (img, t, m) in enumerate(batches):
        if s == 3:
            st = jtr.state
            ttr = TT.YoloTrainer(STEP_CFG, seed=99, device="cpu")
            ttr.load_state(interop.train_state_from_numpy(
                interop.params_to_numpy(st.params), interop.params_to_numpy(st.momentum),
                int(st.batch_num), int(st.seen), "cpu"))
        lj, _ = jtr.train_step(jnp.asarray(img), jnp.asarray(t), jnp.asarray(m))
        lt, _ = ttr.train_step(torch.from_numpy(img), torch.from_numpy(t), torch.from_numpy(m))
        runs["raw" if s < 3 else "resumed"].append((lj, lt))
        if s in (2, 5):
            runs["raw" if s < 3 else "resumed"].append((jax.tree.map(np.asarray, jtr.state), ttr.state))
    return runs


@pytest.mark.parametrize("start", ["raw", "resumed"])
def test_three_train_steps_match_jax(three_steps, start):
    *losses, (sj, st) = three_steps[start]
    for lj, lt in losses:
        assert lt == pytest.approx(lj, rel=STEP_LOSS_RTOL)
    got = interop.train_state_to_numpy(st)
    assert int(got["batch_num"]) == int(sj.batch_num) and int(got["seen"]) == int(sj.seen)
    assert sorted(got["params"]) == sorted(int(k) for k in sj.params)
    for tree in ("params", "momentum"):
        for li, p in getattr(sj, tree).items():
            assert sorted(got[tree][li]) == sorted(p)
            for k, v in p.items():
                _close(got[tree][li][k], v, 0, STEP_ATOL_REL, f"{tree} layer {li} {k}")


def test_train_state_round_trips_through_numpy():
    tr = TT.YoloTrainer(YOLO_CFG, seed=4, device="cpu")
    tr.train_step(torch.from_numpy(_images()), *(torch.from_numpy(a) for a in _truths(_YOLO_CASES["mixed"], 8)))
    arrays = interop.train_state_to_numpy(tr.state)
    assert arrays["params"][0]["w"].shape == (3, 3, 3, 8)  # HWIO, as the JAX TrainState holds it
    back = interop.train_state_from_numpy(arrays["params"], arrays["momentum"], arrays["batch_num"],
                                          arrays["seen"], "cpu")
    again = interop.train_state_to_numpy(back)
    for tree in ("params", "momentum"):
        for li, p in arrays[tree].items():
            for k, v in p.items():
                np.testing.assert_array_equal(again[tree][li][k], v)
    assert (back.batch_num, back.seen) == (1, 4)


@pytest.mark.parametrize("which", ["region", "yolo"])
def test_export_weights_equal_before_any_step(which):
    blob = TT.YoloTrainer(CFGS[which], seed=7, device="cpu").export_weights()
    assert blob == JT.YoloTrainer(CFGS[which], seed=7).export_weights()
    # and it loads back into the port's trainer unchanged
    assert TT.YoloTrainer(CFGS[which], weights_bytes=blob, device="cpu").export_weights() == blob


def test_overfit_single_box():
    """The JAX package's overfit test on the port: 150 SGD steps on one
    repeated image and box cut the loss 5x, and the folded detector finds
    the box within 12 px of its centre."""
    trainer = TT.YoloTrainer(STEP_CFG, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    img = rng.rand(64, 64, 3).astype(np.float32)
    img[24:40, 24:40] = 1.0  # bright square = the object
    images = torch.from_numpy(np.stack([img] * 4))
    t, m = (torch.from_numpy(a) for a in _truths([[(0.5, 0.5, 0.25, 0.25, 0)]] * 4))
    losses = []
    for _ in range(150):  # BN rolling stats (0.99 EMA) need ~100 steps
        loss, stats = trainer.train_step(images, t, m)
        losses.append(loss)
    assert losses[-1] < losses[0] / 5, losses[::10]
    assert float(stats.avg_obj) > 0.5
    assert trainer.batch_num == 150 and trainer.seen == 600

    det = TY.YoloDetector.from_params(STEP_CFG, trainer.folded_params(), conf_threshold=0.3, device="cpu")
    out = det.detect(torch.from_numpy(img))
    assert bool(out.valid[0])
    cx = float(out.boxes[0, 0] + out.boxes[0, 2]) / 2
    cy = float(out.boxes[0, 1] + out.boxes[0, 3]) / 2
    assert abs(cx - 32) < 12 and abs(cy - 32) < 12
    # the exported .weights give the same detector
    det2 = TY.YoloDetector(STEP_CFG, weights_bytes=trainer.export_weights(), conf_threshold=0.3, device="cpu")
    out2 = det2.detect(torch.from_numpy(img))
    assert torch.equal(out2.valid, out.valid)
    np.testing.assert_allclose(n(out2.boxes[out.valid]), n(out.boxes[out.valid]), atol=BOX_TOL_PX)


def test_entry_points_default_to_the_card():
    assert inspect.signature(TT.YoloTrainer).parameters["device"].default == "cuda"
    assert inspect.signature(interop.train_state_from_numpy).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TT.YoloTrainer(TRAIN_CFG)
        with pytest.raises(SystemExit, match="--device cpu"):
            TOOL.main([])


def _root_tool():
    spec = importlib.util.spec_from_file_location("root_train_replay_detector",
                                                  os.path.join(REPO, "tools", "train_replay_detector.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replay_tool_to_net_matches_root_tool():
    root = _root_tool()
    img = np.random.RandomState(3).randint(0, 256, (376, 1241)).astype(np.uint8)
    got, want = TOOL.to_net(img, 352, 352), root.to_net(img, 352, 352)
    assert got.shape == want.shape == (352, 352, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TO_NET_TOL)
    # the training config: the root tool's lines in the zoo cfg's [net]
    assert TOOL.train_cfg("[net]\nchannels=3\n").startswith("[net]\nchannels=3\nmomentum=0.9\n")


def test_replay_tool_truths_and_iou_match_root_tool():
    root = _root_tool()
    assert (TOOL.MAX_T, TOOL.BATCH, TOOL.STEPS, TOOL.N_GT) == (root.MAX_T, root.BATCH, root.STEPS, root.N_GT)
    rng = np.random.RandomState(0)
    for trial in range(20):
        nb = rng.randint(0, 14)  # more boxes than MAX_T slots in some trials
        x1 = rng.uniform(-20, 1200, nb)
        y1 = rng.uniform(-20, 360, nb)
        w = rng.choice([0.5, 2.0, 40.0, 300.0], nb)  # some too small to keep
        h = rng.choice([0.5, 3.0, 60.0, 200.0], nb)
        boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
        valid = rng.rand(nb) < 0.8
        t_got, m_got = TOOL.boxes_to_truths(boxes, valid, 1241, 376, 352, 352)
        t_want, m_want = root.boxes_to_truths(boxes, valid, 1241, 376, 352, 352)
        np.testing.assert_array_equal(t_got, t_want)
        np.testing.assert_array_equal(m_got, m_want)
        for a, b in zip(boxes[:-1], boxes[1:]):
            assert TOOL.iou_xyxy(a, b) == root.iou_xyxy(a, b)


def test_full_width_float32_gradients_stay_near_float64():
    """What the card-vs-CPU bound of chip_smoke.py's training phase rests
    on: at full width (kitti_tiny_v2, 352x352, two letterboxed smoke frames)
    float32 gradients are not exact.  Against float64 each leaf stays within
    7.5e-3 of its norm (half chip_smoke.py's 1.5e-2; 4.0e-3 measured), while
    the 64x64 cfgs above agree with JAX to 1e-4 of the max."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.models import zoo

    tr = TT.YoloTrainer(TOOL.train_cfg(zoo.KITTI_TINY_V2_CFG), seed=0, device="cpu")
    src = two_plane_frame_source(376, 1241)
    x = torch.from_numpy(np.stack([TOOL.to_net(src(i)[0], 352, 352) for i in (2, 3)])).permute(0, 3, 1, 2)
    t, m = (torch.from_numpy(np.stack(a)) for a in zip(
        TOOL.boxes_to_truths([[500, 60, 700, 300]], [True], 1241, 376, 352, 352),
        TOOL.boxes_to_truths([], [], 1241, 376, 352, 352)))
    grads = []
    for dtype in (torch.float32, torch.float64):
        tr.net.to(dtype)
        loss, _, _ = tr.loss(x.to(dtype).contiguous(), t.to(dtype), m)
        grads.append(torch.autograd.grad(loss, [p for *_, p in tr.net.trainable()]))
    worst = max(float((a.double() - b).norm() / b.norm()) for a, b in zip(*grads))
    assert 1e-5 < worst <= 7.5e-3, worst
