"""The plain darknet reference (``vo_bench/reference/detector.py``) against the
port's ``YoloDetector`` on the weights blob that a run makes from its seed,
and against darknet's own arithmetic where the port departs from it.

The port letterboxes with PyTorch's float32 antialiased resize, which on
the CPU is ~6.5e-6 off the float64 filter (the reference's float32 filter:
~1e-7); the network carries that into its heads at ~2.3e-4 to 3.1e-4 of
their RMS on these frames, so heads are held to 1e-3 of their RMS, and
boxes to 0.25 px (~0.08 px read)."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu_torch.io import darknet
from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector
from vo_bench import check, darknet_weights
from vo_bench.reference import detector as ref
from vo_bench.scene import Scene

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
HEAD_RTOL = 1e-3
BOX_PX = 0.25

# stride-1 convolutions, a shortcut, a route of one and of two layers, an
# upsample and two yolo heads
TWO_HEADS_CFG = """
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
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=1
num=6

[route]
layers = -3

[upsample]
stride=2

[route]
layers = -1, 2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

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


def online():
    with open(os.path.join(HERE, "configs", "kitti00_online.json")) as f:
        det = json.load(f)["detector"]
    with open(os.path.join(HERE, "..", det["cfg_file"])) as f:
        return det, f.read()


def scene_frame(seed, t):
    with open(os.path.join(HERE, "traffic", "stream1.json")) as f:
        params = json.load(f)["scene"]
    scene = Scene(params, seed, 0, 376, 1241, 10.0, 32)
    return scene.frame(0).left, scene.frame(t).left


def both(cfg, blob, conf, nms=0.45):
    return (ref.Detector(cfg, blob, conf, nms, 32, CPU),
            YoloDetector(cfg, weights_bytes=blob, conf_threshold=conf, nms_iou=nms, max_boxes=32, device="cpu"))


def agree(cfg, blob, grey, conf):
    """The port's heads, candidates and NMS output against the reference's."""
    reference, port = both(cfg, blob, conf)
    want = reference.detect(grey)
    got = port.heads(grey)
    rms = float(torch.cat([h.flatten() for h in want.heads]).pow(2).mean().sqrt())
    assert len(got) == len(want.heads)
    for (_, g), w in zip(got, want.heads):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= HEAD_RTOL * rms
    # the candidates: every box and score, in the same order
    H, W = grey.shape
    boxes, scores, _ = (x[0] for x in port.candidates(got, W, H))
    ref_boxes, ref_probs = [], []
    for sec, feat in zip([s for s in reference.sections if s["type"] in ref.HEADS], want.heads):
        box, prob = reference.decode(sec, feat)
        ref_boxes.append(reference.unletterbox(box, W, H))
        ref_probs.append(prob)
    ref_boxes, ref_probs = torch.cat(ref_boxes), torch.cat(ref_probs)
    sane = (ref_boxes[:, 2:] - ref_boxes[:, :2]).abs().amax(dim=1) < 4 * max(H, W)   # exp() of a finite logit
    assert torch.allclose(boxes[sane], ref_boxes[sane], rtol=1e-3, atol=BOX_PX)
    above = ref_probs > conf
    assert torch.allclose(scores[above], ref_probs[above], atol=1e-4)
    det = port.detect(grey)
    edged = reference.detect(grey, edges=(check.SCORE_EDGE, check.IOU_EDGE))
    assert not edged.edge.any() and len(edged.optional) == 0   # no decision on an edge
    assert np.array_equal(det.valid.numpy(), want.valid)
    assert np.abs(det.boxes.numpy()[want.valid] - want.boxes[want.valid]).max(initial=0.0) <= BOX_PX
    return want


@pytest.mark.parametrize("seed,t", [(8, 300), (2**31 + 7, 41), (4, 100)])
def test_the_kitti_car_detector_agrees_with_the_port(seed, t):
    det, cfg = online()
    first, left = scene_frame(seed, t)
    blob = darknet_weights.blob(cfg, seed, det, first, CPU)
    want = agree(cfg, blob, torch.from_numpy(left) / 255.0, det["conf_threshold"])
    assert want.heads[0].shape == (1, 30, 11, 11) and 1 <= want.valid.sum() <= 8


def test_route_shortcut_upsample_and_two_yolo_heads_agree_with_the_port():
    first, left = (np.random.default_rng(k).random((48, 64), dtype=np.float32) * 255 for k in (0, 1))
    blob = darknet_weights.blob(TWO_HEADS_CFG, 5, {"conf_threshold": 0.6, "first_frame_candidates": 3}, first, CPU)
    want = agree(TWO_HEADS_CFG, blob, torch.from_numpy(left) / 255.0, 0.6)
    assert [h.shape for h in want.heads] == [(1, 18, 16, 16), (1, 18, 32, 32)] and want.valid.any()


def test_one_blob_gives_both_parsers_the_same_folded_layers():
    det, cfg = online()
    first, _ = scene_frame(3, 0)
    blob = darknet_weights.blob(cfg, 3, det, first, CPU)
    port = darknet.load_weights(darknet.parse_cfg(cfg), blob)
    mine = ref.read_weights(ref.parse_cfg(cfg), blob)
    assert sorted(port) == sorted(mine) == [0, 2, 4, 6, 8, 10, 12, 13, 14]
    for i, (w, b) in mine.items():
        # the same numbers to float32 rounding: darknet divides by (sqrt(var) + 1e-6), the port multiplies by its inverse
        np.testing.assert_allclose(np.transpose(port[i]["w"], (3, 2, 0, 1)), w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(port[i]["b"], b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="short"):
        ref.read_weights(ref.parse_cfg(cfg), blob[:-4])
    with pytest.raises(ValueError, match="left over"):
        ref.read_weights(ref.parse_cfg(cfg), blob + bytes(4))


def test_a_stride_2_convolution_pads_as_darknet_does():
    """darknet pads size / 2 = 1 pixel on every side (parse_convolutional), so
    a 3x3 stride-2 window on a 4x4 image starts at -1; XLA's SAME, as the
    port pads, would pad (0, 1) and start at 0 (out[0, 0] = 45)."""
    cfg = "[net]\nwidth=4\nheight=4\nchannels=1\n\n[convolutional]\nfilters=1\nsize=3\nstride=2\npad=1\nactivation=linear\n"
    blob = np.array([0, 2, 0], "<i4").tobytes() + np.zeros(1, "<i8").tobytes() + np.zeros(1, "<f4").tobytes() \
        + np.ones(9, "<f4").tobytes()
    d = ref.Detector(cfg, blob, 0.5, 0.45, 4, CPU)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)   # x[r, c] = 4 r + c
    out = d._convolve(x, d.convs[0])
    # rows / columns {0, 1} and {1, 2, 3}: 0+1+4+5, 1+2+3+5+6+7, 4+5+8+9+12+13, 5+6+7+9+10+11+13+14+15
    assert out[0, 0].tolist() == [[10.0, 24.0], [51.0, 90.0]]


def test_a_size_2_stride_1_maxpool_pads_right_and_bottom():
    cfg = "[net]\nwidth=3\nheight=2\nchannels=1\n\n[maxpool]\nsize=2\nstride=1\n\n[region]\nanchors=1,1\nclasses=1\nnum=1\n"
    d = ref.Detector(cfg, np.array([0, 2, 0], "<i4").tobytes() + np.zeros(1, "<i8").tobytes(), 0.5, 0.45, 4, CPU)
    (_, out), = d.forward(torch.tensor([[[[1.0, 5.0, 2.0], [3.0, 4.0, -1.0]]]]))
    assert out[0, 0].tolist() == [[5.0, 5.0, 2.0], [4.0, 4.0, -1.0]]


def test_the_letterbox_filter_is_the_antialiased_linear_resize():
    rows = ref.resize_matrix(376, 106)
    assert torch.allclose(rows.sum(dim=1), torch.ones(106, dtype=torch.float64))
    x = torch.rand(376, 1241, dtype=torch.float64)
    want = torch.nn.functional.interpolate(x[None, None], size=(106, 352), mode="bilinear", align_corners=False,
                                           antialias=True)[0, 0]
    assert torch.allclose(rows @ x @ ref.resize_matrix(1241, 352).T, want, atol=1e-12)
    assert ref.letterbox_size(352, 352, 1241, 376) == (352, 106)
    assert torch.equal(ref.resize_matrix(5, 5), torch.eye(5, dtype=torch.float64))


def boxed(*xs):
    """Boxes 100 px wide and tall whose left edges are ``xs``."""
    return np.array([[x, 0.0, x + 100.0, 100.0] for x in xs], np.float32)


def nms(boxes, probs, edges=(check.SCORE_EDGE, check.IOU_EDGE), max_boxes=8):
    net = SimpleNamespace(conf=0.8, nms_iou=0.45, max_boxes=max_boxes)
    return ref.Detector.nms(net, boxes, np.asarray(probs, np.float32), *edges)


def due_and_optional(kept):
    out, valid, edge, optional = kept
    return [round(x, 3) for x in out[valid & ~edge][:, 0]], sorted(round(x, 3) for x in optional[:, 0])


@pytest.mark.parametrize("case,boxes,probs,due,optional", [
    ("apart, firm", boxed(0, 300, 600), [0.95, 0.9, 0.85], [0, 300, 600], []),
    ("a score at the threshold", boxed(0, 300, 600), [0.95, 0.9, 0.80005], [0, 300], [600]),
    ("a score just under it", boxed(0, 300, 600), [0.95, 0.9, 0.79995], [0, 300], [600]),
    # IoU of boxes shifted by 38 px: 62 / 138 = 0.4493, by 37.8: 0.4512
    ("an IoU at the NMS threshold", boxed(0, 37.9, 600), [0.95, 0.9, 0.85], [0, 600], [37.9]),
    ("firmly suppressed", boxed(0, 10, 600), [0.95, 0.9, 0.85], [0, 600], []),
    ("two close scores, one suppresses the other", boxed(0, 10, 600), [0.9, 0.89995, 0.85], [600], [0, 10]),
    ("suppressed by an optional box", boxed(0, 300, 310), [0.95, 0.80005, 0.80003], [0], [300, 310]),
])
def test_nms_leaves_optional_only_the_boxes_whose_fate_rounding_could_turn(case, boxes, probs, due, optional):
    assert due_and_optional(nms(boxes, probs)) == (due, optional), case
    out, valid, edge, optional_none = nms(boxes, probs, edges=(0.0, 0.0))
    assert not edge.any() and len(optional_none) == 0   # no edges: every kept box is due


def test_the_cut_to_the_slots_leaves_optional_the_boxes_around_it():
    # four boxes apart, two slots: the second and third scores lie within the score edge
    kept = nms(boxed(0, 300, 600, 900), [0.95, 0.9, 0.89995, 0.85], max_boxes=2)
    assert due_and_optional(kept) == ([0], [300, 600])


@pytest.mark.parametrize("case,prog,gap,unpaired", [
    ("the same boxes", [0, 300], 0.0, 0),
    ("the optional one too", [0, 300, 600], 0.0, 0),
    ("a box 0.5 px off", [0.5, 300], 0.5, 0),
    ("a due box left out", [0], None, 1),
    ("a box the reference has not", [0, 300, 900], None, 1),
    ("a due box twice", [0, 0, 300], None, 1),
])
def test_the_program_boxes_pair_one_to_one_with_the_due_and_optional_ones(case, prog, gap, unpaired):
    got, n = check.pair_boxes(boxed(*prog).astype(np.float64), boxed(0, 300), boxed(600))
    assert n == unpaired, case
    if gap is not None:
        assert got == pytest.approx(gap)
