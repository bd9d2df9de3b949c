"""PyTorch port, dense stereo (cost volume, WTA, LR check, refine pass,
median) against the JAX package; the SGM aggregation and its kernel are in
test_torch_sgm.py, the dense mode of ``sparse_disparity`` in
test_torch_stereo.py.

The JAX side aggregates with ``dense_backend="xla"`` (its plain scan).
Tolerances, each measured on this suite's inputs:
- medians, the grey and RGB cost volumes and the WTA step: bit-exact (same
  float32 operations in the same order);
- the edge-aware P2 planes: 1 ulp (atol 1e-6 at values <= 8), since
  ``torch.exp`` and XLA's exp differ in the last bit on ~10% of inputs;
- ``dense_disparity`` on a gt_synth crop, which inherits those last-bit
  differences through the P2 planes: valid and measured masks equal on
  >= 99.5% of pixels, disparity within 0.01 px where both are valid.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from stereo_semantic_vo_tpu.core.config import StereoConfig
from stereo_semantic_vo_tpu.kernels import median as JM
from stereo_semantic_vo_tpu.ops import dense_stereo as JD
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig as TSC
from stereo_semantic_vo_tpu_torch.kernels import cost_volume as TCV
from stereo_semantic_vo_tpu_torch.kernels import median as TM
from stereo_semantic_vo_tpu_torch.ops import dense_stereo as TD
from tests.torch_parity import n, t

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "gt_synth")
CFG = StereoConfig(max_disparity=48, dense_backend="xla", edge_p2=True, edge_p2_gamma=5.0)
TCFG = TSC(**dataclasses.asdict(CFG))


def _pair(seed=0, H=40, W=150, shift=7, rgb=False):
    rng = np.random.RandomState(seed)
    shape = (H, W, 3) if rgb else (H, W)
    left = rng.uniform(0, 255, shape).astype(np.float32)
    right = (np.roll(left, -shift, axis=1) + rng.normal(0, 2.0, shape)).astype(np.float32)
    return left, right


@pytest.mark.parametrize("size", [3, 5])
def test_median_exact(size):
    # quantized values: many ties inside each window
    img = np.random.RandomState(size).randint(0, 6, (23, 31)).astype(np.float32)
    jf, tf = (JM.median3x3, TM.median3x3) if size == 3 else (JM.median5x5, TM.median5x5)
    np.testing.assert_array_equal(n(tf(t(img))), n(jf(jnp.asarray(img))))


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("right_base", [False, True])
def test_cost_volume_exact(rgb, right_base):
    left, right = _pair()
    kw_j, kw_t = {}, {}
    if rgb:
        lc, rc = _pair(seed=1, rgb=True)
        kw_j = dict(left_rgb=jnp.asarray(lc), right_rgb=jnp.asarray(rc))
        kw_t = dict(left_rgb=t(lc), right_rgb=t(rc))
    want = n(JD.cost_volume(jnp.asarray(left), jnp.asarray(right), CFG, right_base, **kw_j))
    got = n(TD.cost_volume(t(left), t(right), TCFG, right_base, **kw_t))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend,rgb", [("auto", False), ("auto", True), ("xla", False), ("pallas", False),
                                         ("pallas", True)])
def test_cost_volumes_on_the_cpu_take_the_plain_loop(backend, rgb, monkeypatch):
    """``cost_volumes`` on CPU tensors launches nothing: "auto" and "xla"
    build each base with ``cost_volume``, "pallas" on grey images reaches
    the kernel wrapper, which takes the same plain loop on the CPU, and the
    colour form never reaches it; the volumes equal JAX's bit for bit."""
    left, right = _pair()
    kw_j, kw_t = {}, {}
    if rgb:
        lc, rc = _pair(seed=1, rgb=True)
        kw_j = dict(left_rgb=jnp.asarray(lc), right_rgb=jnp.asarray(rc))
        kw_t = dict(left_rgb=t(lc), right_rgb=t(rc))
    calls = []
    wrapper = TCV.cost_volumes
    monkeypatch.setattr(TCV, "cost_volumes", lambda *a: calls.append(a) or wrapper(*a))
    before = wrapper.launches
    got = TD.cost_volumes(t(left), t(right), dataclasses.replace(TCFG, dense_backend=backend), **kw_t)
    assert wrapper.launches == before
    assert len(calls) == (backend == "pallas" and not rgb)
    for right_base, g in zip((False, True), got):
        want = n(JD.cost_volume(jnp.asarray(left), jnp.asarray(right), CFG, right_base, **kw_j))
        np.testing.assert_array_equal(n(g), want)


@pytest.mark.parametrize("r,D", [(3, 48), (2, 20)])
def test_window_sums_in_the_kernels_order_equal_the_box_sum(r, D):
    """csrc/cost_volume.cu's window sums in numpy: a thread holds a 2 x 4
    block of outputs, starts each at +0.0 and adds every raw cost of its
    (2 + 2r) x (4 + 2r) staged window, input rows then columns rising, to
    each accumulator whose window holds it (the zero pad included): bit
    for bit ``_box_sum``'s sequence of adds, on a shape that leaves ragged
    thread blocks."""
    left, right = _pair(H=21, W=70)
    raw = n(TD.cost_volume(t(left), t(right), dataclasses.replace(TCFG, max_disparity=D, block_radius=0)))
    H, W, P = raw.shape[0], raw.shape[1], 2 * r + 1
    padded = np.pad(raw, ((r, r + 2), (r, r + 4), (0, 0)))  # the zero pad, and room for ragged blocks
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    o, c = ys % 2, xs % 4  # an output's place in its thread's block
    acc = np.zeros_like(raw)
    for ir in range(2 + 2 * r):
        for ic in range(4 + 2 * r):
            holds = (ir - o >= 0) & (ir - o < P) & (ic - c >= 0) & (ic - c < P)
            acc = np.where(holds[..., None], acc + padded[ys - o + ir, xs - c + ic], acc)
    np.testing.assert_array_equal(acc, n(TD._box_sum(t(raw), r)))


def test_wta_subpixel_exact():
    agg = np.random.RandomState(3).randint(0, 40, (30, 50, 48)).astype(np.float32)  # many ties
    agg[0, 0, :] = 5.0                                                               # all tied
    want = n(JD._wta_subpixel(jnp.asarray(agg), 0.5))
    np.testing.assert_array_equal(n(TD._wta_subpixel(t(agg), 0.5)), want)


def test_edge_p2_planes_within_one_ulp():
    left, _ = _pair()
    for a, b in zip(TD.edge_p2_planes(t(left), TCFG), JD.edge_p2_planes(jnp.asarray(left), CFG)):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


def _gt_crop(name="boxes", rows=slice(40, 136), cols=slice(40, 280)):
    def load(side):
        img = Image.open(os.path.join(FIXDIR, f"{name}_{side}.png")).convert("L")
        return np.asarray(img, np.float32)[rows, cols].copy()

    return load("left"), load("right")


@pytest.mark.parametrize("refine", [True, False])
def test_dense_disparity_matches_jax(refine):
    left, right = _gt_crop()
    cj = dataclasses.replace(CFG, refine=refine)
    ct = dataclasses.replace(TCFG, refine=refine)
    dj = JD.dense_disparity(jnp.asarray(left), jnp.asarray(right), cj)
    dt = TD.dense_disparity(t(left), t(right), ct)
    for name in ("valid", "measured"):
        agree = np.mean(n(getattr(dt, name)) == n(getattr(dj, name)))
        assert agree >= 0.995, (name, agree)
    both = n(dt.valid) & n(dj.valid)
    assert both.mean() > 0.5
    np.testing.assert_allclose(n(dt.disparity)[both], n(dj.disparity)[both], rtol=0, atol=0.01)
