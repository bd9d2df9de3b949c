"""PyTorch port, kernel 6's batched entry: the left and right volumes of a
frame aggregated in one call (``ops/dense_stereo.sgm_aggregate_batch``,
``kernels/sgm_scan.sgm_aggregate_batch`` and its plain version) and
``dense_disparity`` built on it, against the JAX package.

The JAX side aggregates with ``dense_backend="xla"`` (its plain scan).
Tolerances: the batched aggregation bit-exact against one plain call per
volume and against JAX (min, add and subtract in the reference's order);
``dense_disparity`` bit-exact against its one-volume-a-call form, and
within test_torch_dense_stereo.py's bounds of JAX (masks equal on >= 99.5%
of pixels, disparity within 0.01 px: ``torch.exp`` and XLA's exp differ in
the last bit, which reaches the edge-aware P2 planes)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from stereo_semantic_vo_tpu.core.config import StereoConfig
from stereo_semantic_vo_tpu.ops import dense_stereo as JD
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig as TSC
from stereo_semantic_vo_tpu_torch.kernels import sgm_scan as TG
from stereo_semantic_vo_tpu_torch.ops import dense_stereo as TD
from tests.torch_parity import n, t

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "gt_synth")
CFG = StereoConfig(max_disparity=48, dense_backend="xla", edge_p2=True, edge_p2_gamma=5.0)
TCFG = TSC(**dataclasses.asdict(dataclasses.replace(CFG, dense_backend="pallas")))


def _vols(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 3, shape).astype(np.float32) for _ in range(2)]


def _planes(shape, seed):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(1, 8, shape[:2]).astype(np.float32), rng.uniform(1, 8, shape[:2]).astype(np.float32))
            for _ in range(2)]


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("shape", [(40, 150, 48), (13, 67, 48)])
def test_batch_equals_one_call_a_volume_and_jax(shape, planes, scale):
    vols = _vols(shape, sum(shape))
    pl = _planes(shape, 3) if planes else [(None, None)] * 2
    tp = [tuple(None if p is None else t(p) for p in pair) for pair in pl]
    # TCFG asks for the kernel: on CPU tensors its wrapper is the plain batch
    got = [n(x) for x in TD.sgm_aggregate_batch([t(v) for v in vols], TCFG, tp, scale)]
    for v, pair, (ph, pv), g in zip(vols, pl, tp, got):
        one = TG.sgm_aggregate_plain(t(v), CFG.p1 * scale, CFG.p2 * scale,
                                     None if ph is None else ph * scale, None if pv is None else pv * scale)
        np.testing.assert_array_equal(g, n(one))
        jp = [None if p is None else jnp.asarray(p) for p in pair]
        np.testing.assert_array_equal(g, n(JD.sgm_aggregate(jnp.asarray(v), CFG, *jp, scale=scale)))


def _gt_crop(name="boxes", rows=slice(40, 136), cols=slice(40, 280)):
    def load(side):
        img = Image.open(os.path.join(FIXDIR, f"{name}_{side}.png")).convert("L")
        return np.asarray(img, np.float32)[rows, cols].copy()

    return load("left"), load("right")


@pytest.mark.parametrize("refine", [True, False])
def test_dense_disparity_with_both_volumes_alive(refine, monkeypatch):
    left, right = _gt_crop()
    ct = dataclasses.replace(TCFG, refine=refine)
    calls = []
    batch = TD.sgm_aggregate_batch

    def counted(vols, *args, **kw):
        calls.append(len(vols))
        return batch(vols, *args, **kw)

    monkeypatch.setattr(TD, "sgm_aggregate_batch", counted)
    dt = TD.dense_disparity(t(left), t(right), ct)
    assert calls == ([2, 1] if refine else [2])  # left and right in one call, then the refine pass

    # the port's form before the batch: one aggregation call a volume
    def one_a_call(vols, cfg, planes=None, scale=1.0):
        planes = planes or [(None, None)] * len(vols)
        return [batch([v], cfg, [p], scale)[0] for v, p in zip(vols, planes)]

    monkeypatch.setattr(TD, "sgm_aggregate_batch", one_a_call)
    before = TD.dense_disparity(t(left), t(right), ct)
    for name, a, b in zip(dt._fields, dt, before):
        np.testing.assert_array_equal(n(a), n(b), err_msg=name)

    dj = JD.dense_disparity(jnp.asarray(left), jnp.asarray(right), dataclasses.replace(CFG, refine=refine))
    for name in ("valid", "measured"):
        agree = np.mean(n(getattr(dt, name)) == n(getattr(dj, name)))
        assert agree >= 0.995, (name, agree)
    both = n(dt.valid) & n(dj.valid)
    assert both.mean() > 0.5
    np.testing.assert_allclose(n(dt.disparity)[both], n(dj.disparity)[both], rtol=0, atol=0.01)
