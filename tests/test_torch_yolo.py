"""PyTorch port of the online detector against the JAX package, on the CPU.

The same numpy inputs and the same folded params go through
``stereo_semantic_vo_tpu.models.yolo`` / ``io.darknet`` and their ports.
Tolerances:
- darknet I/O: bit-equal (the port's copy is the same numpy code);
- head maps: rtol 1e-5 with atol 1e-6 x max|JAX| (float32 convolutions
  summed in another order; an element near 0 has no relative precision);
- ``decode_head``: rtol 1e-5, atol 1e-6 (sigmoid, exp and softmax of two
  libraries);
- ``iou_xyxy`` and ``nms_fixed``: bit-equal (the same float32 operations in
  the same order, first maximum on ties);
- ``letterbox`` at 376x1241: 1e-5 (antialiased bilinear resize of two
  libraries); ``unletterbox_boxes``: 1e-4 px;
- ``YoloDetector.detect`` on a 1241x376 frame: boxes within 1e-2 px, scores
  within 1e-5, classes and valid equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.io import darknet as JD
from stereo_semantic_vo_tpu.models import yolo as JY
from stereo_semantic_vo_tpu.models import zoo as JZ
from stereo_semantic_vo_tpu_torch.io import darknet as TD
from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
from stereo_semantic_vo_tpu_torch.models import yolo as TY
from stereo_semantic_vo_tpu_torch.models import zoo as TZ

HEAD_RTOL, HEAD_ATOL_REL = 1e-5, 1e-6
DECODE_RTOL, DECODE_ATOL = 1e-5, 1e-6
LETTERBOX_TOL, UNLETTERBOX_TOL_PX = 1e-5, 1e-4
BOX_TOL_PX, SCORE_TOL = 1e-2, 1e-5

# 64x64 input, 8-32 filters: a stride-2 conv on an even input (SAME pads
# (0, 1)), a size-2 stride-1 maxpool (pads right and bottom with -inf), a
# shortcut with leaky, a region head; then a route, an upsample, a
# two-layer route and a yolo head
MINI_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=32
size=3
stride=1
pad=1
activation=leaky

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

[route]
layers = -4

[upsample]
stride=2

[route]
layers = -1, 4

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=1
num=6
"""


def _sections(text=MINI_CFG):
    return TD.parse_cfg(text)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _assert_heads_close(want, got):
    assert len(want) == len(got)
    for (sj, fj), (st, ft) in zip(want, got):
        assert sj["type"] == st["type"]
        fj = np.asarray(fj)
        assert fj.shape == _nhwc(ft).shape
        np.testing.assert_allclose(_nhwc(ft), fj, rtol=HEAD_RTOL, atol=HEAD_ATOL_REL * np.abs(fj).max())


def _smoke_frame() -> np.ndarray:
    """Frame 0 of io/synthetic.py's 1241x376 scene in [0, 1]."""
    left, _ = two_plane_frame_source(376, 1241)(0)
    return (left / 255.0).astype(np.float32)


@pytest.mark.parametrize("text", [MINI_CFG, TZ.KITTI_TINY_V2_CFG, TZ.TINY_V3_CFG])
def test_parse_cfg_and_layer_shapes_equal_jax(text):
    assert TD.parse_cfg(text) == JD.parse_cfg(text)
    assert TD.conv_layer_shapes(TD.parse_cfg(text)) == JD.conv_layer_shapes(JD.parse_cfg(text))


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for idx in a:
        assert a[idx].keys() == b[idx].keys()
        for k in a[idx]:
            assert a[idx][k].dtype == b[idx][k].dtype
            np.testing.assert_array_equal(a[idx][k], b[idx][k])


@pytest.mark.parametrize("seed", [0, 5])
def test_raw_weights_load_through_both_packages_bit_equal(seed):
    """random_weights_raw -> save_weights_raw -> load_weights: both
    packages fold the same blob to the same params; fold_params of the raw
    load equals the folded load, and the raw round trip is exact."""
    sections = _sections()
    raw = TD.random_weights_raw(sections, seed)
    rng = np.random.RandomState(seed)
    for p in raw.values():  # batch-norm statistics other than the identity
        if "scales" in p:
            p["scales"] = rng.uniform(0.5, 1.5, p["scales"].shape).astype(np.float32)
            p["mean"] = rng.normal(0, 0.1, p["mean"].shape).astype(np.float32)
            p["var"] = rng.uniform(0.5, 2.0, p["var"].shape).astype(np.float32)
    blob = TD.save_weights_raw(sections, raw, seen=seed)
    assert blob == JD.save_weights_raw(JD.parse_cfg(MINI_CFG), raw, seen=seed)
    folded = TD.load_weights(sections, blob)
    _assert_params_equal(folded, JD.load_weights(JD.parse_cfg(MINI_CFG), blob))
    _assert_params_equal(TD.fold_params(TD.load_weights_raw(sections, blob)), folded)
    _assert_params_equal(TD.load_weights_raw(sections, blob), raw)
    _assert_params_equal(TD.fold_params(raw), JD.fold_params(raw))


@pytest.mark.parametrize("fn", ["random_weights", "random_weights_raw"])
def test_random_weights_equal_jax(fn):
    sections = _sections(TZ.TINY_V3_CFG)
    _assert_params_equal(getattr(TD, fn)(sections, 3), getattr(JD, fn)(JD.parse_cfg(TZ.TINY_V3_CFG), 3))


def test_save_weights_roundtrip_equals_jax():
    sections = _sections()
    rng = np.random.RandomState(1)
    unfolded = {}
    for info in TD.conv_layer_shapes(sections):
        n, c, k = info["n"], info["c"], info["size"]
        p = {"biases": rng.normal(0, 0.1, n).astype(np.float32),
             "w_oihw": rng.normal(0, 0.2, (n, c, k, k)).astype(np.float32)}
        if info["bn"]:
            p.update(scales=np.ones(n, np.float32), mean=np.zeros(n, np.float32), var=np.ones(n, np.float32))
        unfolded[info["index"]] = p
    blob = TD.save_weights(sections, unfolded)
    assert blob == JD.save_weights(JD.parse_cfg(MINI_CFG), unfolded)
    _assert_params_equal(TD.load_weights(sections, blob), JD.load_weights(JD.parse_cfg(MINI_CFG), blob))


def test_truncated_weights_raise():
    sections = _sections()
    blob = TD.save_weights_raw(sections, TD.random_weights_raw(sections))
    with pytest.raises(ValueError, match="truncated"):
        TD.load_weights(sections, blob[:-8])


@pytest.mark.parametrize("size", [64, 63, 48])
def test_forward_matches_jax_per_head(size):
    """MINI_CFG's every layer kind, at an even input (stride-2 SAME pads
    (0, 1)) and an odd one (pads (1, 1))."""
    sections = _sections()
    params = TD.random_weights(sections, seed=2)
    x = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = JY.forward(params, JD.parse_cfg(MINI_CFG), jnp.asarray(x))
    got = TY.forward(params, sections, _nchw(x))
    if size == 64:
        assert [tuple(f.shape) for _, f in got] == [(2, 30, 16, 16), (2, 18, 32, 32)]
    _assert_heads_close(want, got)


def test_same_padding_and_maxpool_borders():
    """XLA's SAME: stride-1 3x3 pads (1, 1), stride-2 3x3 on an even input
    (0, 1), on an odd input (1, 1), 1x1 nothing; the size-2 stride-1 pool
    keeps the size."""
    assert TY._same_pads(32, 3, 1) == (1, 1)
    assert TY._same_pads(32, 3, 2) == (0, 1)
    assert TY._same_pads(33, 3, 2) == (1, 1)
    assert TY._same_pads(32, 1, 1) == (0, 0)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4) - 20.0
    y = TY._maxpool(x, 2, 1)
    assert y.shape == x.shape
    assert float(y[0, 0, 3, 3]) == float(x[0, 0, 3, 3])  # the -inf pad never wins


@pytest.mark.parametrize("which,size", [("kitti_tiny_v2", 352), ("tiny_v3", 416)])
def test_full_width_heads_match_jax(which, size):
    """kitti_tiny_v2 at 352x352 -> (1, 11, 11, 30); tiny_v3 at 416x416 ->
    its two yolo heads."""
    jdet = getattr(JZ, which)()
    tdet = TY.YoloDetector.from_params(getattr(TZ, which.upper() + "_CFG"), jdet.params, device="cpu")
    x = np.random.RandomState(0).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    want = JY.forward(jdet.params, jdet.sections, jnp.asarray(x))
    got = TY.forward(jdet.params, tdet.sections, _nchw(x))
    shapes = [tuple(np.asarray(f).shape) for _, f in want]
    assert shapes == ([(1, 11, 11, 30)] if which == "kitti_tiny_v2" else [(1, 13, 13, 18), (1, 26, 26, 18)])
    _assert_heads_close(want, got)


@pytest.mark.parametrize("head", ["region", "yolo"])
def test_decode_head_matches_jax(head):
    """A random feature map through both decoders: boxes, class scores and
    objectness in JAX's flat (h, w, anchor) order."""
    sec = next(s for s in _sections() if s["type"] == head)
    sec.update(_net_w=64, _net_h=64)
    C, h, w = (30, 16, 16) if head == "region" else (18, 32, 32)
    feat = np.random.RandomState(4).normal(0, 2, (2, h, w, C)).astype(np.float32)
    want = JY.decode_head(sec, jnp.asarray(feat), 1)
    got = TY.decode_head(sec, _nchw(feat), 1, torch.from_numpy(TY.head_anchors(sec)))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=DECODE_RTOL, atol=DECODE_ATOL)


def test_decode_head_two_classes_softmax_matches_jax():
    sec = {"type": "region", "anchors": (0.5, 0.8, 1.0, 1.5), "num": 2, "softmax": 1, "classes": 2}
    feat = np.random.RandomState(5).normal(0, 2, (1, 5, 7, 2 * 7)).astype(np.float32)
    got = TY.decode_head(sec, _nchw(feat), 2, torch.from_numpy(TY.head_anchors(sec)))
    for a, b in zip(JY.decode_head(sec, jnp.asarray(feat), 2), got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=DECODE_RTOL, atol=DECODE_ATOL)


def _nms_inputs(seed):
    """Boxes with exact duplicates and tied top scores; ~40% zero scores,
    so a long ``max_out`` runs into an all-suppressed tail."""
    rng = np.random.RandomState(seed)
    N = 96
    xy = rng.uniform(0, 300, (N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 80, (N, 2))], 1).astype(np.float32)
    boxes[10] = boxes[3]
    boxes[11] = boxes[3] + 0.5
    boxes[12] = [5, 5, 5, 40]  # zero area
    scores = np.round(rng.uniform(0, 1, N), 2).astype(np.float32)
    scores[rng.rand(N) < 0.4] = 0.0
    scores[[5, 7, 10]] = scores.max()
    return boxes, scores


@pytest.mark.parametrize("seed", [3, 4])
def test_iou_matches_jax_bit_for_bit(seed):
    boxes, _ = _nms_inputs(seed)
    want = np.asarray(JY.iou_xyxy(jnp.asarray(boxes), jnp.asarray(boxes[:40])))
    got = TY.iou_xyxy(torch.from_numpy(boxes), torch.from_numpy(boxes[:40])).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_out", [8, 32, 96])
@pytest.mark.parametrize("iou_th", [0.45, 0.3])
def test_nms_fixed_matches_jax_bit_for_bit(max_out, iou_th):
    boxes, scores = _nms_inputs(3)
    want = JY.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), max_out, iou_th)
    got = TY.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), max_out, iou_th)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if max_out == 96:  # the tail: nothing left, boxes[argmax] with valid False
        assert not got[2][-1] and float(got[1][-1]) == 0.0


def test_nms_fixed_with_nothing_alive_returns_invalid_first_box():
    boxes, _ = _nms_inputs(3)
    b, s, v = TY.nms_fixed(torch.from_numpy(boxes), torch.zeros(len(boxes)), 4, 0.45)
    assert not v.any() and not s.any()
    assert torch.equal(b, torch.from_numpy(boxes[[0, 0, 0, 0]]))


def test_letterbox_and_unletterbox_match_jax():
    img = np.stack([_smoke_frame()] * 3, -1)
    want = np.asarray(JY.letterbox(jnp.asarray(img), 352, 352, 1241, 376))
    got = TY.letterbox(torch.from_numpy(img), 352, 352, 1241, 376).numpy()
    assert got.shape == (352, 352, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=LETTERBOX_TOL)
    assert (got[:123] == 0.5).all() and (got[229:] == 0.5).all()  # 106 rows at offset 123
    rel = np.random.RandomState(6).uniform(0, 1, (64, 4)).astype(np.float32)
    want = np.asarray(JY.unletterbox_boxes(jnp.asarray(rel), 352, 352, 1241, 376))
    got = TY.unletterbox_boxes(torch.from_numpy(rel), 352, 352, 1241, 376).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=UNLETTERBOX_TOL_PX)


@pytest.fixture(scope="module")
def smoke_detections():
    jdet = JZ.kitti_tiny_v2()
    tdet = TY.YoloDetector.from_params(TZ.KITTI_TINY_V2_CFG, jdet.params, device="cpu")
    img = _smoke_frame()
    return jdet.detect(jnp.asarray(img)), tdet.detect(torch.from_numpy(img)), tdet, img


def test_detect_matches_jax_on_a_smoke_frame(smoke_detections):
    """kitti_tiny_v2 with JAX's random weights at conf 0.8 on frame 0 of the
    1241x376 scene: every one of the 32 slots fires."""
    want, got, _, _ = smoke_detections
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    assert got.classes.dtype == torch.int32 and got.valid.dtype == torch.bool
    v = got.valid.numpy()
    assert v.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], rtol=0, atol=BOX_TOL_PX)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=SCORE_TOL)


def test_detect_takes_gray_and_rgb_alike(smoke_detections):
    _, got, tdet, img = smoke_detections
    rgb = tdet.detect(torch.from_numpy(np.stack([img] * 3, -1)))
    for a, b in zip(got, rgb):
        assert torch.equal(a, b)


def test_detector_from_weights_equals_from_params():
    sections = _sections(TZ.KITTI_TINY_V2_CFG)
    blob = TD.save_weights_raw(sections, TD.random_weights_raw(sections, 7))
    a = TZ.kitti_tiny_v2(weights_bytes=blob, device="cpu")
    b = TY.YoloDetector.from_params(TZ.KITTI_TINY_V2_CFG, TD.load_weights(sections, blob), device="cpu")
    for (_, fa), (_, fb) in zip(a.net(torch.full((1, 3, 352, 352), 0.5)), b.net(torch.full((1, 3, 352, 352), 0.5))):
        assert torch.equal(fa, fb)
    assert (a.conf_threshold, a.nms_iou, a.max_boxes) == (0.8, 0.45, 32)
    assert TZ.tiny_v3(device="cpu").conf_threshold == 0.5


def test_zoo_structure_matches_jax():
    for which in ("kitti_tiny_v2", "tiny_v3"):
        t, j = getattr(TZ, which)(device="cpu"), getattr(JZ, which)()
        assert t.sections == j.sections and (t.net_w, t.net_h) == (j.net_w, j.net_h)
        _assert_params_equal(t.params, j.params)


def test_detector_defaults_to_the_card():
    """No silent fallback: without a CUDA device the default device fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TZ.kitti_tiny_v2()
