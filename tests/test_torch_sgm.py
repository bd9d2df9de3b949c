"""PyTorch port, SGM aggregation (``ops/dense_stereo._sgm_pass`` /
``sgm_aggregate``) and the plain version of kernel 6
(``kernels/sgm_scan.py``) against the JAX package.

The JAX side runs its plain scan (``dense_backend="xla"``) and, for the
kernel's contract, ``sgm_aggregate_pallas`` in interpret mode.
Tolerances: every directional sweep and the plain 4-path aggregation
bit-exact (min, add and subtract in the reference's order); against the
Pallas kernel atol 2e-4, the reference's own bound, since it sums
(h_f + h_b) + (v_f + v_b)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.config import StereoConfig
from stereo_semantic_vo_tpu.kernels.sgm_scan import sgm_aggregate_pallas
from stereo_semantic_vo_tpu.ops import dense_stereo as JD
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig as TSC
from stereo_semantic_vo_tpu_torch.ops import dense_stereo as TD
from tests.torch_parity import n, t

CFG = StereoConfig(max_disparity=48, dense_backend="xla", edge_p2=True, edge_p2_gamma=5.0)
TCFG = TSC(**dataclasses.asdict(CFG))


def _vol(h=40, w=150, d=48, seed=0):
    return np.random.RandomState(seed).uniform(0, 3, (h, w, d)).astype(np.float32)


def _plane(h, w, seed=7):
    return np.random.RandomState(seed).uniform(1.0, 8.0, (h, w)).astype(np.float32)


@pytest.mark.parametrize("axis,reverse", [(1, False), (1, True), (0, False), (0, True)])
def test_sgm_pass_exact(axis, reverse):
    vol = _vol(seed=axis * 2 + reverse)
    plane = _plane(40, 150)
    for p2x in (None, plane):
        want = n(JD._sgm_pass(jnp.asarray(vol), 1.0, 8.0, axis, reverse,
                              None if p2x is None else jnp.asarray(p2x)))
        got = n(TD._sgm_pass(t(vol), 1.0, 8.0, axis, reverse, None if p2x is None else t(p2x)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(40, 150, 48), (13, 67, 48)])
@pytest.mark.parametrize("planes", [False, True])
def test_sgm_aggregate_matches_jax_xla_and_pallas(shape, planes):
    vol = _vol(*shape, seed=sum(shape))
    H, W, _ = shape
    ph, pv = (_plane(H, W, 1), _plane(H, W, 2)) if planes else (None, None)
    jp = [None if p is None else jnp.asarray(p) for p in (ph, pv)]
    tp = [None if p is None else t(p) for p in (ph, pv)]
    got = n(TD.sgm_aggregate(t(vol), TCFG, *tp, scale=0.5))
    np.testing.assert_array_equal(got, n(JD.sgm_aggregate(jnp.asarray(vol), CFG, *jp, scale=0.5)))
    # the kernel's contract: planes and penalties come in scaled
    want = n(sgm_aggregate_pallas(
        jnp.asarray(vol), CFG.p1 * 0.5, CFG.p2 * 0.5,
        p2x_h=None if ph is None else jnp.asarray(ph * 0.5).T,
        p2x_v=None if pv is None else jnp.asarray(pv * 0.5),
    ))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    # on a CPU tensor the kernel's wrapper is its plain version, bit for bit
    pauto = dataclasses.replace(TCFG, dense_backend="auto")
    np.testing.assert_array_equal(n(TD.sgm_aggregate(t(vol), pauto, *tp, scale=0.5)), got)
