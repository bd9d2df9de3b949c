"""PyTorch port, kernel 5 (the fused motion-only BA build) against the JAX
package.

The JAX side runs its Pallas build in interpret mode.  Tolerances:
H and g within rtol 2e-5 and atol 1e-6 x max|reference|, the cost within
rtol 1e-5 (tests/test_ba_hessian.py's bounds: float32 sums over K=512 in
another order); the LM pose of ``motion_only_ba(hessian_backend="pallas")``
within 1e-5 of JAX's, trimmed and untrimmed, with equal inlier masks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core import Camera as JCam
from stereo_semantic_vo_tpu.core import CameraConfig as JCamCfg
from stereo_semantic_vo_tpu.core import lie as JL
from stereo_semantic_vo_tpu.core.config import BAConfig as JBA
from stereo_semantic_vo_tpu.kernels.ba_hessian import motion_hessian_gradient as j_motion
from stereo_semantic_vo_tpu.ops import ba as JB
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.core.config import BAConfig as TBA
from stereo_semantic_vo_tpu_torch.core.config import CameraConfig as TCamCfg
from stereo_semantic_vo_tpu_torch.kernels import ba_hessian as TK
from stereo_semantic_vo_tpu_torch.ops import ba as TB
from tests.test_ba_hessian import _problem
from tests.torch_parity import n, t

JC, TC = JCam.from_config(JCamCfg()), TCam.from_config(TCamCfg(), "cpu")
T_INTR = TK.motion_intrinsics(TC)
DELTA = float(JBA().huber_delta)


def _pose(xi):
    return n(JL.se3_exp(jnp.asarray(xi, jnp.float32)))


def _inputs(seed=0, K=512):
    X, uv, mask, T_true = (n(a) for a in _problem(seed=seed, K=K))
    T0 = (_pose([0.05, 0.0, -0.04, 0.004, 0.0, -0.003]) @ T_true).astype(np.float32)
    m = mask.astype(np.float32)
    m[::37] = 0.0  # a few trimmed observations
    return X, uv, mask, m, T0, T_true


@pytest.mark.parametrize("seed", [0, 4])
def test_plain_matches_pallas_interpret(seed):
    X, uv, _, m, T0, _ = _inputs(seed)
    want = j_motion(jnp.asarray(T0), jnp.asarray(X.T), jnp.asarray(uv.T), jnp.asarray(m[None]), JC, DELTA)
    got = TK.motion_hessian_gradient_plain(t(T0), t(X.T), t(uv.T), t(m[None]), T_INTR, DELTA)
    H, g, cost = (n(a) for a in want)
    np.testing.assert_allclose(n(got[0]), H, rtol=2e-5, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(n(got[1]), g, rtol=2e-5, atol=1e-6 * np.abs(g).max())
    np.testing.assert_allclose(float(got[2]), float(cost), rtol=1e-5)
    np.testing.assert_array_equal(n(got[0]), n(got[0]).T)  # built from the 21 unique entries


def test_cpu_wrapper_takes_plain_version():
    X, uv, _, m, T0, _ = _inputs()
    args = (t(T0), t(X.T), t(uv.T), t(m[None]), T_INTR, DELTA)
    before = TK.motion_hessian_gradient.launches
    got = TK.motion_hessian_gradient(*args)
    assert TK.motion_hessian_gradient.launches == before  # no kernel launch for a CPU tensor
    for a, b in zip(got, TK.motion_hessian_gradient_plain(*args)):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("trim_px", [0.0, 10.0])
def test_motion_only_ba_fused_matches_jax(trim_px):
    X, uv, mask, _, T0, T_true = _inputs(seed=3)
    T0 = (_pose([0.08, -0.02, -0.06, 0.006, -0.002, 0.004]) @ T_true).astype(np.float32)
    jcfg = dataclasses.replace(JBA(), hessian_backend="pallas", trim_px=trim_px)
    tcfg = TBA(**dataclasses.asdict(jcfg))
    bj = JB.motion_only_ba(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask), JC, jcfg)
    bt = TB.motion_only_ba(t(T0), t(X), t(uv), t(mask), TC, tcfg)
    np.testing.assert_allclose(n(bt.T_cw), n(bj.T_cw), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(bt.inlier_mask), n(bj.inlier_mask))
    np.testing.assert_allclose(float(bt.cost), float(bj.cost), rtol=1e-4)
    np.testing.assert_allclose(n(bt.T_cw), T_true, atol=5e-3)  # converged, as test_ba_hessian requires


@pytest.mark.parametrize("kwargs", [{"use_huber": False}, {"stereo": True}])
def test_fused_build_only_for_huber_mono(kwargs):
    """Without Huber weights or with the stereo row the reference keeps the
    einsum build, whatever the knob says: "pallas" equals "xla" exactly."""
    X, uv, mask, _, T0, _ = _inputs(seed=5)
    extra = {}
    if kwargs.get("stereo"):
        extra = dict(ur=t(uv[:, 0] - 12.0), ur_mask=t(np.arange(len(X)) % 3 != 0))
    huber = kwargs.get("use_huber", True)
    res = [TB.motion_only_ba(t(T0), t(X), t(uv), t(mask), TC, TBA(hessian_backend=b), use_huber=huber, **extra)
           for b in ("xla", "pallas")]
    np.testing.assert_array_equal(n(res[0].T_cw), n(res[1].T_cw))
