"""PyTorch port, sparse stereo and kernel 2 (per-keypoint costs) against
the JAX package.

The JAX side runs its Pallas cost kernel in interpret mode and
``sparse_disparity`` in "strips" mode (its CPU "auto" picks "volume", a
different contract).  Tolerances: costs rtol 1e-5 (same float32 terms,
summed in another order); valid masks equal; disparity atol 1e-4.  The
epilogue the port's kernel fuses is held to a jnp transcription of the JAX
caller's on crafted costs (its own tolerances are in that test)."""


import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.camera import Camera as JCam
from stereo_semantic_vo_tpu.core.camera import disparity_to_depth as j_depth
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


def _j_epilogue(acc, shift, kp_valid, cam, cfg, D, r):
    """stereo_semantic_vo_tpu/ops/stereo.py:146-148 and 177-207 in jnp, on
    the TPU kernel's strip-order costs; -> (disparity, depth, valid, cost,
    best)."""
    P = 2 * r + 1
    big = 1e9
    d_idx = jnp.arange(D)[None, :]
    costs = acc[:, ::-1]
    addressable = (D - 1 - d_idx) >= shift[:, None]
    costs = jnp.where(addressable, costs, big)
    best = jnp.argmin(costs, axis=1)
    c0 = jnp.take_along_axis(costs, best[:, None], axis=1)[:, 0]
    neighbor = jnp.abs(d_idx - best[:, None]) <= 1
    c1 = jnp.min(jnp.where(neighbor, big, costs), axis=1)
    unique = c0 < cfg.uniqueness_ratio * c1
    cm = jnp.take_along_axis(costs, jnp.clip(best - 1, 0, D - 1)[:, None], axis=1)[:, 0]
    cp = jnp.take_along_axis(costs, jnp.clip(best + 1, 0, D - 1)[:, None], axis=1)[:, 0]
    denom = 2.0 * (jnp.maximum(cm, cp) - c0)
    delta = jnp.clip(jnp.where(denom > 1e-6, (cm - cp) / denom, 0.0), -0.5, 0.5)
    disp = best.astype(jnp.float32) + delta
    max_win_cost = (cfg.color_weight * cfg.color_trunc + cfg.grad_weight * cfg.grad_trunc) * P * P
    valid = (kp_valid & unique & (disp > cfg.min_disparity) & (best > 0) & (best < D - 1)
             & (c0 < 0.8 * max_win_cost))
    depth = jnp.where(valid, j_depth(cam, disp, cfg.min_disparity), 0.0)
    return jnp.where(valid, disp, -1.0), depth, valid, c0, best


def _crafted_costs(K=64, seed=7):
    """(K, D) strip-order costs (strip offset s = D-1-d), (K,) shifts and
    validity, with the epilogue's edge cases in the first rows."""
    rng = np.random.RandomState(seed)
    s = lambda d: D - 1 - d  # noqa: E731
    acc = rng.uniform(20.0, 60.0, (K, D)).astype(np.float32)
    for k in range(K):  # a clear V-shaped minimum at d < 30, addressable for shift < 18
        d = rng.randint(3, 30)
        acc[k, s(d)], acc[k, s(d - 1)], acc[k, s(d + 1)] = 4.0, 9.0 + k % 5, 11.0
    shift = rng.randint(-5, 12, K).astype(np.int32)
    valid = rng.rand(K) > 0.15
    acc[0] = 5.0                                # flat: every cost ties -> d = 0, denom 0
    acc[1, s(33)] = acc[1, s(34)] = 1.0         # tied neighbours: the lower d, delta 0.5
    acc[2, s(35)] = acc[2, s(42)] = 1.0         # tied apart: the lower d, not unique
    acc[3, s(0)] = 0.5                          # best at d = 0
    acc[4, s(D - 1)] = 0.5                      # best at d = D-1
    acc[5, s(40)] = 0.5                         # denom <= 1e-6: cm = cp = c0 + 1 ulp
    acc[5, s(39)] = acc[5, s(41)] = np.nextafter(np.float32(0.5), np.float32(1.0))
    acc[6, s(45)] = 0.1                         # the smallest cost at s = 2 < shift: masked
    acc[9, s(45)] = 0.1                         # the same with shift < 0 (right edge): kept
    acc[10] = 300.0                             # c0 above 0.8 x the largest window cost
    acc[10, s(20)] = 290.0
    acc[11, s(40)] = 4.1                        # the runner-up within the uniqueness ratio
    acc[12] = acc[13]                           # a good keypoint, not valid
    shift[:14] = [0, 0, 0, 0, 0, 0, 10, D + 3, 47, -4, 0, 0, 0, 0]  # 7: none addressable, 8: only d = 0
    valid[:14] = True
    valid[12] = False
    return acc, shift, valid


def test_epilogue_plain_matches_jax_on_crafted_costs():
    """keypoint_disparity_plain's epilogue against the JAX caller's on
    crafted costs: ties and a flat row, the best at d=0 and d=D-1, a
    denominator <= 1e-6, unaddressable offsets (shift > 0, shift >= D), an
    invalid keypoint.  valid, argmin and cost equal; disparity atol 1e-6 and
    depth rtol 1e-6: the same float32 operations, but XLA may rewrite a
    division (e.g. into a reciprocal and a product)."""
    acc, shift, valid = _crafted_costs()
    cfg, cam = StereoConfig(), JCam.from_config(CameraConfig())
    want = _j_epilogue(jnp.asarray(acc), jnp.asarray(shift), jnp.asarray(valid), cam, cfg, D, RAD)
    tc = TSC()
    got = TS.disparity_from_costs(t(acc), t(shift), t(valid), TCam.from_config(CameraConfig(), "cpu").bf, D, RAD,
                                  tc.color_weight, tc.grad_weight, tc.color_trunc, tc.grad_trunc,
                                  tc.uniqueness_ratio, tc.min_disparity)
    disp, depth, ok, cost, best = (n(x) for x in got)
    np.testing.assert_array_equal(best, n(want[4]))
    np.testing.assert_array_equal(ok, n(want[2]))
    np.testing.assert_array_equal(cost, n(want[3]))
    np.testing.assert_allclose(disp, n(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(depth, n(want[1]), rtol=1e-6, atol=0)
    # the cases took the branches they were made for
    assert list(best[[0, 1, 2, 3, 4, 5, 7, 8, 9, 10]]) == [0, 33, 35, 0, D - 1, 40, 0, 0, 45, 20]
    assert best[6] < 30 and cost[7] == 1e9 and disp[1] == 33.5 and disp[5] == 40.0
    assert ok[[1, 5, 6, 9, 13]].all() and not ok[[0, 2, 3, 4, 7, 8, 10, 11, 12]].any()


@pytest.mark.parametrize("D_,r", [(64, 2), (32, 4)])
def test_keypoint_disparity_matches_jax_strips_at_other_windows(D_, r):
    """The step at windows other than kitti()'s (the kernel's runtime-shape
    instantiation on the card), against the JAX package's strips mode; on a
    CPU tensor it is the plain step and launches nothing."""
    left, right = _scene(seed=5)
    uv, valid = _keypoints(*left.shape)
    jc = StereoConfig(sparse_mode="strips", max_disparity=D_, block_radius=r)
    a = j_sparse(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(valid),
                 JCam.from_config(CameraConfig()), jc)
    tc = TSC(max_disparity=D_, block_radius=r)
    before = TS.keypoint_stereo_costs.launches
    b = TS.keypoint_disparity(t(left), t(right), t(uv), t(valid), TCam.from_config(CameraConfig(), "cpu").bf, D_, r,
                              tc.color_weight, tc.grad_weight, tc.color_trunc, tc.grad_trunc, tc.uniqueness_ratio,
                              tc.min_disparity)
    assert TS.keypoint_stereo_costs.launches == before
    np.testing.assert_array_equal(n(b[2]), n(a.valid))
    assert n(a.valid).sum() > 20
    np.testing.assert_allclose(n(b[0]), n(a.disparity), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(b[1]), n(a.depth), rtol=1e-4)
    np.testing.assert_allclose(n(b[3]), n(a.cost), rtol=1e-5)


@pytest.mark.parametrize("mode", ["volume", "volume2"])
def test_unported_modes_raise(mode):
    """The whole-image modes, refused until they were ported, now run and
    match the JAX package's (tests/test_torch_volume_stereo.py has the
    rest): valid equal, disparity within 1e-4 px, depth rtol 1e-5."""
    left, right = _scene()
    uv, valid = _keypoints(*left.shape)
    a = j_sparse(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(valid),
                 JCam.from_config(CameraConfig()), StereoConfig(sparse_mode=mode))
    b = t_sparse(t(left), t(right), t(uv), t(valid), TCam.from_config(CameraConfig(), "cpu"), TSC(sparse_mode=mode))
    np.testing.assert_array_equal(n(b.valid), n(a.valid))
    assert n(a.valid).sum() > 20
    np.testing.assert_allclose(n(b.disparity), n(a.disparity), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(b.depth), n(a.depth), rtol=1e-5)


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
