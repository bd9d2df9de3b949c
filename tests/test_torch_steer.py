"""PyTorch port, steered BRIEF (``ORBConfig.steer=True``) against the JAX
package.

Tolerances, and why:
- intensity-centroid moments: rtol 1e-5 of the batch's largest moment.
  Both sum the same float32 products, in another order (XLA's dot against
  a float32 matmul): ~0.3 on moments up to ~3e4;
- angles within 1e-4 rad where the moment vector is at least 10% of the
  largest (90% of the keypoints here): a moment error of 1e-5 of the
  largest turns such an angle by at most 1e-4 rad, and turns the angle of
  a near-zero moment arbitrarily;
- descriptors fed the JAX package's angles: bit-exact (the same rotation,
  round-half-even and clamp in float32);
- ``extract_orb`` end to end: uv, level and valid exact, at most 0.5% of
  the valid keypoints' descriptor bits differ (an ulp of angle may move a
  rotated sample across a pixel boundary);
- the rotation test of tests/test_orb.py, on the port alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from stereo_semantic_vo_tpu.core.config import ORBConfig as JORB
from stereo_semantic_vo_tpu.ops import orb as JO
from stereo_semantic_vo_tpu_torch.core.config import ORBConfig as TORB
from stereo_semantic_vo_tpu_torch.kernels import hamming as TH
from stereo_semantic_vo_tpu_torch.ops import orb as TO
from tests.torch_parity import n, t, one_torch_thread  # noqa: F401 (autouse fixture)

HALF = 15
SEED = 0x0B5E55ED
MOMENT_FLOOR = 0.1  # of the largest moment


def _texture(shape, seed, k=3):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    return convolve2d(img, np.ones((k, k)) / (k * k), mode="same").astype(np.float32)


@pytest.fixture(scope="module")
def smoothed():
    """A smoothed level image, keypoints inside the border and near every
    edge (their rotated samples reach outside the image and clamp)."""
    img_s = n(JO._smooth(jnp.asarray(_texture((120, 400), 0)), 9))
    H, W = img_s.shape
    rng = np.random.RandomState(1)
    xy = np.stack([rng.randint(19, W - 19, 300), rng.randint(19, H - 19, 300)], -1)
    edges = np.array([[0, 0], [W - 1, H - 1], [3, H // 2], [W // 2, 2], [W - 4, 5], [10, H - 11]])
    return img_s, np.concatenate([xy, edges]).astype(np.int32)


def _jax_moments(patches):
    wx, wy = JO._ic_weights(HALF, patches.shape[1], patches.shape[2])
    flat = jnp.asarray(patches).reshape(patches.shape[0], -1)
    hp = jax.lax.Precision.HIGHEST
    return np.stack([n(jnp.dot(flat, jnp.asarray(w), precision=hp)) for w in (wx, wy)], -1)


def test_ic_moments_match_jax(smoothed):
    img_s, xy = smoothed
    patches = n(JO._patches(jnp.asarray(img_s), jnp.asarray(xy), HALF))
    want = _jax_moments(patches)
    got = n(TO.ic_moments(t(patches), HALF))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_angles_match_jax_where_the_moment_is_not_near_zero(smoothed):
    img_s, xy = smoothed
    want = n(JO._orientation(jnp.asarray(img_s), jnp.asarray(xy), HALF))
    patches = n(JO._patches(jnp.asarray(img_s), jnp.asarray(xy), HALF))
    got = n(TO.orientation_from_patches(t(patches), HALF))
    norm = np.linalg.norm(_jax_moments(patches), axis=1)
    far = norm >= MOMENT_FLOOR * norm.max()
    assert far.mean() >= 0.85
    err = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - want))))
    assert err[far].max() <= 1e-4, err[far].max()


@pytest.mark.parametrize("angles", ["jax", "quarter_turns"])
def test_describe_fed_the_jax_angles_is_bit_exact(smoothed, angles):
    img_s, xy = smoothed
    if angles == "jax":
        a = n(JO._orientation(jnp.asarray(img_s), jnp.asarray(xy), HALF))
    else:  # exact multiples of pi/2 and their neighbours: rotated samples on .5 ties
        a = np.resize(np.array([0.0, np.pi / 2, -np.pi, np.pi / 4, 1e-7], np.float32), len(xy))
    pattern = JO.brief_pattern(SEED)
    want = n(JO._describe(jnp.asarray(img_s), jnp.asarray(xy), jnp.asarray(a), jnp.asarray(pattern)))
    got = n(TO.describe(t(img_s), t(xy), t(a), TO._pattern(SEED, 256, 31, torch.device("cpu"))))
    np.testing.assert_array_equal(got.view(np.uint32), want)


def _bits_differ(a, b) -> int:
    x = np.bitwise_xor(a.view(np.uint32), b.view(np.uint32))
    return int(np.unpackbits(x.view(np.uint8)).sum())


@pytest.mark.parametrize("levels", [1, 3])
def test_extract_orb_steered_matches_jax(levels):
    img = _texture((120, 320), 2)
    cj = JORB(max_keypoints=256, n_levels=levels)
    kj = JO.extract_orb(jnp.asarray(img), cj)
    kt = TO.extract_orb(t(img), TORB(**dataclasses.asdict(cj)))
    for f in ("uv", "level", "valid"):
        np.testing.assert_array_equal(n(getattr(kt, f)), n(getattr(kj, f)), err_msg=f)
    v = n(kj.valid)
    assert v.sum() > 100
    assert np.abs(n(kt.angle)).max() > 1.0  # steered: real angles, not the upright zeros
    differ = _bits_differ(n(kt.desc)[v], n(kj.desc)[v])
    assert differ <= 0.005 * v.sum() * 256, differ


def test_patch_kernel_backend_gives_the_same_keypoints_on_the_cpu():
    """"pallas" takes B1's plain version on a CPU tensor: the steered
    keypoints are those of the "xla" gather, bit for bit."""
    img = _texture((96, 256), 3)
    a = TO.extract_orb(t(img), TORB(max_keypoints=128, n_levels=2, patch_backend="pallas"))
    b = TO.extract_orb(t(img), TORB(max_keypoints=128, n_levels=2, patch_backend="xla"))
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_90_degree_rotation():
    """tests/test_orb.py's rotation test on the port: steered BRIEF matches
    across a 90-degree rotation (exact pixels), with consistent geometry."""
    img = _texture((256, 256), 0, k=4)
    rot = np.rot90(img).copy()
    cfg = TORB(max_keypoints=256, n_levels=3)
    kp1, kp2 = TO.extract_orb(t(img), cfg), TO.extract_orb(t(rot), cfg)
    d = TH.hamming_distance_matrix(kp1.desc, kp2.desc)
    idx, best, _ = TH.masked_best_match(d, kp1.valid, kp2.valid)
    v = n(kp1.valid)
    matched = (n(best) < 50) & v
    assert matched.sum() > 0.6 * v.sum()
    # np.rot90 (ccw): (x, y) -> (y, W-1-x)
    W = img.shape[1]
    uv1, uv2 = n(kp1.uv), n(kp2.uv)[n(idx)]
    expect = np.stack([uv1[matched, 1], W - 1 - uv1[matched, 0]], axis=1)
    assert np.median(np.linalg.norm(uv2[matched] - expect, axis=1)) < 1.0
