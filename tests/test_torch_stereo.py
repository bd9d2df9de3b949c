"""PyTorch port, sparse stereo and kernel 2 (per-keypoint costs) against
the JAX package.

The JAX side runs its Pallas cost kernel in interpret mode and
``sparse_disparity`` in "strips" mode (its CPU "auto" picks "volume", a
different contract).  Tolerances: costs rtol 1e-5 (same float32 terms,
summed in another order); valid masks equal; disparity atol 1e-4."""


import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.camera import Camera as JCam
from stereo_semantic_vo_tpu.core.config import CameraConfig, StereoConfig
from stereo_semantic_vo_tpu.kernels.sparse_stereo import keypoint_stereo_costs as j_costs
from stereo_semantic_vo_tpu.ops.stereo import sparse_disparity as j_sparse
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig as TSC
from stereo_semantic_vo_tpu_torch.kernels import sparse_stereo as TS
from stereo_semantic_vo_tpu_torch.ops.stereo import sparse_disparity as t_sparse
from tests.test_stereo import textured
from tests.torch_parity import n, t

D, RAD = 48, 3
PW = 2 * RAD + 1
WEIGHTS = (0.11, 0.89, 7.0, 2.0)


def _scene(seed=0, H=96, W=240, shift=12):
    left = textured(seed, H, W)
    right = np.roll(left, -shift, axis=1) + np.random.RandomState(seed).normal(0, 1.0, (H, W)).astype(np.float32)
    return left, right


def _origins(H, W, K=64, seed=0):
    rng = np.random.RandomState(seed)
    y0 = rng.randint(0, H - PW + 1, K).astype(np.int32)
    xl0 = rng.randint(0, W - PW + 1, K).astype(np.int32)
    xr0 = rng.randint(0, W - (D + 2 * RAD) + 1, K).astype(np.int32)
    xl0[:4] = [0, W - PW, 0, 1]  # gradient wrap at both image edges
    xr0[:4] = [0, W - D - 2 * RAD, 0, 1]
    return y0, xl0, xr0


def test_costs_plain_matches_pallas_interpret():
    left, right = _scene()
    y0, xl0, xr0 = _origins(*left.shape)
    want = n(j_costs(*(jnp.asarray(a) for a in (left, right, y0, xl0, xr0)), D, RAD, *WEIGHTS))
    got = n(TS.keypoint_stereo_costs(*(t(a) for a in (left, right, y0, xl0, xr0)), D, RAD, *WEIGHTS))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_xgrad_wraps_like_roll():
    img = np.random.RandomState(1).uniform(0, 255, (8, 20)).astype(np.float32)
    want = (np.roll(img, -1, axis=1) - np.roll(img, 1, axis=1)) * np.float32(0.5)
    np.testing.assert_array_equal(n(TS.xgrad(t(img))), want)


def _keypoints(H, W, K=96, seed=2):
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    uv[:6] = [[0, 0], [W - 1, H - 1], [2.5, 40], [W - 1.5, 3.5], [60.5, 20.5], [61.5, 21.5]]
    valid = rng.rand(K) > 0.1
    return uv, valid


@pytest.mark.parametrize("mode", ["strips", "pallas", "auto"])
def test_sparse_disparity_matches_jax_strips(mode):
    left, right = _scene(seed=3)
    uv, valid = _keypoints(*left.shape)
    a = j_sparse(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(valid),
                 JCam.from_config(CameraConfig()), StereoConfig(sparse_mode="strips"))
    b = t_sparse(t(left), t(right), t(uv), t(valid), TCam.from_config(CameraConfig(), "cpu"),
                 TSC(sparse_mode=mode))
    np.testing.assert_array_equal(n(b.valid), n(a.valid))
    assert n(a.valid).sum() > 20
    np.testing.assert_allclose(n(b.disparity), n(a.disparity), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(b.depth), n(a.depth), rtol=1e-4)
    np.testing.assert_allclose(n(b.cost), n(a.cost), rtol=1e-5)


@pytest.mark.parametrize("mode", ["volume", "volume2"])
def test_unported_modes_raise(mode):
    left, right = _scene()
    uv, valid = _keypoints(*left.shape, K=8)
    with pytest.raises(NotImplementedError, match="A3"):
        t_sparse(t(left), t(right), t(uv), t(valid), TCam.from_config(CameraConfig(), "cpu"), TSC(sparse_mode=mode))


def test_dense_mode_matches_jax():
    """Dense disparity sampled at the keypoints, against the JAX package's
    dense mode: valid masks differ on at most one keypoint, disparity within
    0.01 px (the dense disparity inherits a last-bit difference of ``exp``,
    see test_torch_dense_stereo.py)."""
    left, right = _scene()
    uv, valid = _keypoints(*left.shape)
    a = j_sparse(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(valid),
                 JCam.from_config(CameraConfig()), StereoConfig(sparse_mode="dense", dense_backend="xla"))
    b = t_sparse(t(left), t(right), t(uv), t(valid), TCam.from_config(CameraConfig(), "cpu"), TSC(sparse_mode="dense"))
    va, vb = n(a.valid), n(b.valid)
    assert np.sum(va != vb) <= 1 and va.sum() > 30
    both = va & vb
    np.testing.assert_allclose(n(b.disparity)[both], n(a.disparity)[both], rtol=0, atol=0.01)
    np.testing.assert_allclose(n(b.depth)[both], n(a.depth)[both], rtol=1e-3)
    np.testing.assert_array_equal(n(b.cost), 0.0)
