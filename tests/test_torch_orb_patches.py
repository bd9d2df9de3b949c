"""PyTorch port, ORB and kernel 1 (patch extraction) against the JAX package.

The JAX side runs its Pallas patch kernel in interpret mode.  Tolerances:
patches, FAST, NMS, blur, grid top-k and one-level ORB are bit-exact; the
pyramid resize weights agree to 1e-6 (float32 rounding of the column
normalization) and resized images to 1e-4 grey levels; with 3 levels, at
least 99% of valid keypoint slots are identical (a near-tie BRIEF bit may
flip on a resized level)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.config import ORBConfig as JORB
from stereo_semantic_vo_tpu.kernels.patch_extract import extract_patches as j_extract_patches
from stereo_semantic_vo_tpu.ops import orb as JO
from stereo_semantic_vo_tpu_torch.core.config import ORBConfig as TORB
from stereo_semantic_vo_tpu_torch.kernels import patch_extract as TP
from stereo_semantic_vo_tpu_torch.ops import orb as TO
from tests.torch_parity import n, t

R = 15
P = 2 * R + 1


@pytest.fixture(scope="module")
def img():
    return np.random.RandomState(3).uniform(0, 255, (120, 400)).astype(np.float32)


def _origins(H, W, count=60, seed=0):
    """Clamped top-left origins: interior plus every border-clamp case."""
    rng = np.random.RandomState(seed)
    xs = np.concatenate([rng.randint(0, W, count - 4), [0, W - 1, 5, W - 3]])
    ys = np.concatenate([rng.randint(0, H, count - 4), [0, 2, H - 1, H - 2]])
    y0 = np.clip(ys - R, 0, H - P).astype(np.int32)
    x0 = np.clip(xs - R, 0, W - P).astype(np.int32)
    return y0, x0


def test_patch_plain_matches_pallas_interpret(img):
    H, W = img.shape
    y0, x0 = _origins(H, W)
    slab = n(j_extract_patches(jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), R))
    got = n(TP.extract_patches(t(img), t(y0), t(x0), R))
    assert got.shape == (len(y0), P, P)
    np.testing.assert_array_equal(got, slab[:, :P, :P])


@pytest.mark.parametrize("n_in,n_out", [(376, 313), (1241, 1034), (862, 718), (120, 100), (400, 333)])
def test_resize_matrix_matches_jax(n_in, n_out):
    want = n(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in), "linear"))
    np.testing.assert_allclose(TO.resize_matrix(n_in, n_out), want, rtol=0, atol=1e-6)


def test_resize_image_matches_jax(img):
    want = n(jax.image.resize(jnp.asarray(img), (100, 333), "linear"))
    np.testing.assert_allclose(n(TO.resize_linear(t(img), 100, 333)), want, rtol=0, atol=1e-4)


def test_fast_nms_smooth_bit_exact(img):
    for a, b in zip(JO._fast_score(jnp.asarray(img), 20.0, 7.0), TO._fast_score(t(img), (20.0, 7.0))):
        np.testing.assert_array_equal(n(b), n(a))
        np.testing.assert_array_equal(n(TO._nms3(b)), n(JO._nms3(a)))
    np.testing.assert_array_equal(n(TO._smooth(t(img), 9)), n(JO._smooth(jnp.asarray(img), 9)))


def test_grid_topk_ties_go_to_lower_index():
    score = np.zeros((64, 128), np.float32)
    score[5, 7] = score[40, 100] = 3.0
    score[6, 9] = 3.0  # tie inside one cell
    fj, sj = JO._grid_topk(jnp.asarray(score), 4, 8, 3)
    ft, st = TO._grid_topk(t(score), 4, 8, 3)
    np.testing.assert_array_equal(n(ft), n(fj))
    np.testing.assert_array_equal(n(st), n(sj))


def test_describe_upright_matches_onehot_matmul(img):
    H, W = img.shape
    y0, x0 = _origins(H, W, seed=1)
    patches = n(TP.extract_patches_plain(t(img), t(y0), t(x0), R))
    want = n(JO._describe_upright(jnp.asarray(patches), 7, 256, 31))
    np.testing.assert_array_equal(n(TO._describe_upright(t(patches), 7, 256, 31)).view(np.uint32), want)


def _orb_pair(img, levels):
    cj = JORB(max_keypoints=128, n_levels=levels, steer=False, patch_backend="xla")
    ct = TORB(**dataclasses.asdict(dataclasses.replace(cj, patch_backend="auto")))
    return JO.extract_orb(jnp.asarray(img), cj), TO.extract_orb(t(img), ct)


def test_extract_orb_one_level_equal(img):
    kj, kt = _orb_pair(img, 1)
    for f in ("uv", "valid", "level", "response", "angle"):
        np.testing.assert_array_equal(n(getattr(kt, f)), n(getattr(kj, f)), err_msg=f)
    np.testing.assert_array_equal(n(kt.desc).view(np.uint32), n(kj.desc))


def test_extract_orb_three_levels_agree(img):
    kj, kt = _orb_pair(img, 3)
    np.testing.assert_array_equal(n(kt.valid), n(kj.valid))
    same = (n(kt.uv) == n(kj.uv)).all(1) & (n(kt.desc).view(np.uint32) == n(kj.desc)).all(1)
    assert same[n(kj.valid)].mean() >= 0.99


def test_unported_orb_options_raise(img):
    """No ORB option is left unported: ``steer=True``, refused until steered
    BRIEF was ported, now runs (tests/test_torch_steer.py holds it to the
    JAX package)."""
    kp = TO.extract_orb(t(img), TORB(max_keypoints=64, n_levels=2, steer=True))
    assert int(kp.valid.sum()) > 0 and float(kp.angle.abs().max()) > 0.0


def test_cpu_wrapper_takes_plain_version(img):
    before = TP.extract_patches_levels.launches  # extract_patches counts there
    TP.extract_patches(t(img), t(np.zeros(4, np.int32)), t(np.zeros(4, np.int32)), R)
    assert TP.extract_patches_levels.launches == before  # no kernel launch for a CPU tensor
