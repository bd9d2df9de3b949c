"""PyTorch port of the YOLO training path against the JAX package, on the CPU.

The same numpy inputs and raw params go through
``stereo_semantic_vo_tpu.models.yolo_train`` and its port, on the JAX
tests' 64x64 ``TRAIN_CFG`` (region head, batch 4) and a 64x64 two-head
yolo cfg (route, upsample).  Inputs carry constant regions, so that max-pool
windows hold ties and their gradient must go where JAX sends it (the first
maximum).  Tolerances:
- head maps: rtol 1e-5, atol 1e-5 x max|JAX| (float32 convolutions and BN
  sums in another order); rolling statistics atol 1e-6;
- losses: rtol 1e-5 (the same float32 terms summed in another order);
  ``avg_iou`` and ``avg_obj`` rtol 1e-5, atol 1e-7; ``count`` and ``recall``
  exact; the loss's gradient on the head map atol 1e-5 x max|JAX|;
- ``learning_rate``: rtol 1e-6 (float32 ``pow`` and ``exp`` of two
  libraries).

The leaves' gradients, train steps, weights export and the replay tool's
pieces are in test_torch_yolo_train_steps.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.io import darknet as JD
from stereo_semantic_vo_tpu.models import yolo_train as JT
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.io import darknet as TD
from stereo_semantic_vo_tpu_torch.models import yolo_train as TT
from tests.test_yolo_train import TRAIN_CFG
from tests.torch_parity import n, one_torch_thread  # noqa: F401

HEAD_RTOL, HEAD_ATOL_REL, STAT_ATOL = 1e-5, 1e-5, 1e-6
LOSS_RTOL, AVG_ATOL, FEAT_GRAD_ATOL_REL = 1e-5, 1e-7, 1e-5
LR_RTOL = 1e-6

# 64x64, two yolo heads: 8x8 (mask 3,4,5) and, through a route and an
# upsample, 16x16 (mask 0,1,2); 2 classes
YOLO_CFG = """
[net]
batch=4
width=64
height=64
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.003
burn_in=0
policy=constant

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
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 3,4,5
anchors = 6,8, 10,14, 18,22, 24,30, 34,40, 48,56
classes=2
num=6
ignore_thresh=.5

[route]
layers = -4

[upsample]
stride=2

[route]
layers = -1, -7

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 6,8, 10,14, 18,22, 24,30, 34,40, 48,56
classes=2
num=6
ignore_thresh=.5
"""
CFGS = {"region": TRAIN_CFG, "yolo": YOLO_CFG}


def _images(B=4, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, 64, 64, 3).astype(np.float32)
    x[:, 8:28, 8:28] = 0.5   # constant regions: every 2x2 pool window there ties
    x[1, 40:60, 30:62] = 1.0
    return x


def _truths(boxes_per_img, T=JT.MAX_TRUTHS):
    B = len(boxes_per_img)
    t = np.zeros((B, T, 5), np.float32)
    m = np.zeros((B, T), bool)
    for b, lst in enumerate(boxes_per_img):
        for i, box in enumerate(lst):
            if box is not None:
                t[b, i] = box
                m[b, i] = True
    return t, m


def _raw(cfg_text, seed=3, stats=False):
    raw = JD.random_weights_raw(JD.parse_cfg(cfg_text), seed=seed)
    if stats:  # non-trivial rolling statistics for the eval-mode forward
        rng = np.random.RandomState(0)
        for p in raw.values():
            if "scales" in p:
                p["mean"] = (rng.randn(*p["mean"].shape) * 0.1).astype(np.float32)
                p["var"] = rng.uniform(0.5, 2.0, p["var"].shape).astype(np.float32)
                p["scales"] = rng.uniform(0.5, 1.5, p["scales"].shape).astype(np.float32)
                p["b"] = (rng.randn(*p["b"].shape) * 0.1).astype(np.float32)
    return raw


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close(got, want, rtol, atol_rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("which", ["region", "yolo"])
def test_forward_train_heads_and_rolling_stats(which, train):
    cfg = CFGS[which]
    raw = _raw(cfg, stats=True)
    x = _images()
    heads_j, new_j = JT.forward_train(jax.tree.map(jnp.asarray, raw), JD.parse_cfg(cfg), jnp.asarray(x), train=train)
    net = TT.YoloTrainNet(TD.parse_cfg(cfg), raw)
    with torch.no_grad():
        heads_t, rolling = net(_nchw(x), train=train)
    assert len(heads_t) == len(heads_j) == (1 if which == "region" else 2)
    for (sj, fj), (st, ft) in zip(heads_j, heads_t):
        assert sj["type"] == st["type"]
        _close(n(ft.permute(0, 2, 3, 1)), fj, HEAD_RTOL, HEAD_ATOL_REL, "head map")
    assert sorted(rolling) == sorted(li for li, p in raw.items() if "scales" in p)
    for li, (rm, rv) in rolling.items():
        np.testing.assert_allclose(n(rm), new_j[li]["mean"], rtol=0, atol=STAT_ATOL)
        np.testing.assert_allclose(n(rv), new_j[li]["var"], rtol=0, atol=STAT_ATOL)
        if not train:
            np.testing.assert_array_equal(n(rm), raw[li]["mean"])


# two truths of image 0 on cell (4, 4) with the same shape (the same anchor
# under bias_match): the later one must win; a masked-off slot between them
# on the same cell must change nothing; image 2 has no truth
_COLLIDE = [
    [(0.52, 0.53, 0.25, 0.25, 0), None, (0.55, 0.56, 0.25, 0.25, 0), (0.2, 0.3, 0.1, 0.4, 0)],
    [(0.8, 0.2, 0.6, 0.3, 0)],
    [],
    [(0.1, 0.9, 0.05, 0.05, 0), (0.9, 0.9, 0.9, 0.9, 0)],
]
_REGION_CASES = {
    # name: (section overrides, seen, truths per image, truth slots)
    "collide_past_burn_in": ({}, JT.BURN_IN_SEEN, _COLLIDE, 8),
    "collide_in_burn_in": ({}, 0, _COLLIDE, 8),
    "rescore": ({"rescore": 1}, JT.BURN_IN_SEEN, _COLLIDE, 8),
    "no_bias_match_three_classes_logistic": (
        {"bias_match": 0, "classes": 3, "softmax": 0}, 100,
        [[(0.52, 0.53, 0.25, 0.25, 2), None, (0.55, 0.56, 0.25, 0.25, 1)], [(0.3, 0.6, 0.2, 0.1, 1)], [], []], 30),
    "no_truth_slots": ({}, JT.BURN_IN_SEEN, [[], [], [], []], 0),
    "no_truth_slots_in_burn_in": ({}, 5, [[], [], [], []], 0),
}


def _region_case(name, seed=0):
    over, seen, boxes, T = _REGION_CASES[name]
    sec = dict(JD.parse_cfg(TRAIN_CFG)[-1], **over)
    A, nc = int(sec["num"]), int(sec["classes"])
    feat = (np.random.RandomState(seed).randn(4, 8, 8, A * (5 + nc)) * 0.5).astype(np.float32)
    t, m = _truths(boxes, T)
    return feat, sec, t, m, seen


def _key(sec):
    return tuple(sorted(sec.items()))


@functools.lru_cache(maxsize=None)
def _jax_loss(kind, sec_key):
    """The JAX loss's value, stats and head gradient as one jitted function
    of (feat, truths, mask, seen): cases that share a section share its
    compile."""
    sec = dict(sec_key)

    def f(feat, t, m, seen):
        if kind == "region":
            s = JT.region_loss(feat, sec, t, m, seen=seen)
        else:
            s = JT.yolo_loss(feat, sec, t, m, 64, 64)
        return s.loss, s

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _check_stats(s_t, s_j):
    np.testing.assert_allclose(float(s_t.loss.detach()), float(s_j.loss), rtol=LOSS_RTOL)
    for k in ("avg_iou", "avg_obj"):
        np.testing.assert_allclose(float(getattr(s_t, k).detach()), float(getattr(s_j, k)), rtol=LOSS_RTOL,
                                   atol=AVG_ATOL)
    assert float(s_t.count) == float(s_j.count)
    assert float(s_t.recall) == float(s_j.recall)


@pytest.mark.parametrize("name", sorted(_REGION_CASES))
def test_region_loss_and_its_gradient_match_jax(name):
    feat, sec, t, m, seen = _region_case(name)
    tj, mj = t, m
    if t.shape[1] == 0:
        # the reference cannot trace its truth scan over zero slots (ROADMAP
        # C); its loss with masked-off slots is the same function
        with pytest.raises(IndexError):
            JT.region_loss(jnp.asarray(feat), sec, jnp.asarray(t), jnp.asarray(m), seen=seen)
        tj, mj = np.zeros((4, 8, 5), np.float32), np.zeros((4, 8), bool)
    (_, s_j), g_j = _jax_loss("region", _key(sec))(feat, tj, mj, seen)
    ft = _nchw(feat).requires_grad_()
    s_t = TT.region_loss(ft, sec, torch.from_numpy(t), torch.from_numpy(m), seen=seen)
    (g_t,) = torch.autograd.grad(s_t.loss, ft)
    _check_stats(s_t, s_j)
    if name.startswith("collide"):
        assert float(s_j.count) == 6.0  # the masked slot and the empty image assign nothing
    _close(n(g_t.permute(0, 2, 3, 1)), g_j, 0, FEAT_GRAD_ATOL_REL, "d loss / d head")


_YOLO_CASES = {
    # name: (truths per image) on the 8x8 head with mask 3,4,5 of 64x64 input
    "assigned": [[(0.5, 0.5, 0.5, 0.6, 1), (0.52, 0.53, 0.55, 0.62, 0)], [(0.2, 0.7, 0.4, 0.45, 0)], [], []],
    # best anchors 0-2 lie in the other head's mask: nothing is assigned here
    "not_owned": [[(0.5, 0.5, 0.1, 0.12, 0)], [(0.3, 0.3, 0.15, 0.2, 1)], [], []],
    "mixed": [[(0.5, 0.5, 0.1, 0.12, 0), (0.25, 0.75, 0.7, 0.8, 1), None, (0.27, 0.77, 0.72, 0.81, 0)],
              [(0.9, 0.1, 0.5, 0.5, 1)], [(0.6, 0.4, 0.05, 0.06, 0)], [(0.01, 0.99, 0.6, 0.6, 1)]],
}


@pytest.mark.parametrize("name", sorted(_YOLO_CASES))
def test_yolo_loss_and_its_gradient_match_jax(name):
    sec = [s for s in JD.parse_cfg(YOLO_CFG) if s["type"] == "yolo"][0]
    feat = (np.random.RandomState(2).randn(4, 8, 8, 3 * 7) * 0.5).astype(np.float32)
    t, m = _truths(_YOLO_CASES[name], 8)

    (_, s_j), g_j = _jax_loss("yolo", _key(sec))(feat, t, m, 0)
    ft = _nchw(feat).requires_grad_()
    s_t = TT.yolo_loss(ft, sec, torch.from_numpy(t), torch.from_numpy(m), 64, 64)
    (g_t,) = torch.autograd.grad(s_t.loss, ft)
    _check_stats(s_t, s_j)
    assert (float(s_j.count) == 0.0) == (name == "not_owned")
    _close(n(g_t.permute(0, 2, 3, 1)), g_j, 0, FEAT_GRAD_ATOL_REL, "d loss / d head")


def test_yolo_loss_refuses_zero_truth_slots_as_jax_does():
    sec = [s for s in JD.parse_cfg(YOLO_CFG) if s["type"] == "yolo"][0]
    feat = np.zeros((2, 8, 8, 21), np.float32)
    t, m = np.zeros((2, 0, 5), np.float32), np.zeros((2, 0), bool)
    with pytest.raises(ValueError):
        JT.yolo_loss(jnp.asarray(feat), sec, jnp.asarray(t), jnp.asarray(m), 64, 64)
    with pytest.raises(IndexError):
        TT.yolo_loss(_nchw(feat), sec, torch.from_numpy(t), torch.from_numpy(m), 64, 64)


_LR_NETS = {
    "steps": {"policy": "steps", "steps": (300, 500), "scales": (0.1, 0.5)},
    "step": {"policy": "step", "step": 150, "scale": 0.5},
    "exp": {"policy": "exp", "gamma": 0.999},
    "poly": {"policy": "poly", "max_batches": 400, "power": 2},
    "sig": {"policy": "sig", "gamma": 0.05, "step": 300},
    "constant": {"policy": "constant"},
}


@pytest.mark.parametrize("policy", sorted(_LR_NETS))
def test_learning_rate_matches_jax(policy):
    for burn_in in (0, 100):
        net = {"learning_rate": 0.003, "burn_in": burn_in, "power": 4, **_LR_NETS[policy]}
        for b in (0, 1, 50, 99, 100, 101, 149, 150, 151, 299, 300, 301, 499, 500, 501, 1000):
            got, want = TT.learning_rate(net, b), float(JT.learning_rate(net, b))
            assert got == pytest.approx(want, rel=LR_RTOL, abs=0), (burn_in, b, got, want)
