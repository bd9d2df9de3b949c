"""PyTorch port, kernel 1 for all pyramid levels at once
(``kernels/patch_extract.extract_patches_levels``) and ``extract_orb``'s one
patch call a frame, against the JAX package.

The JAX side runs its Pallas patch kernel in interpret mode, level by level.
Tolerances: patches bit-exact (a copy); ``extract_orb`` keypoints,
descriptors and their order bit-exact against the port's per-level form
(the same patches and BRIEF tests, gathered in one call) and against JAX,
whose FAST responses on the resized levels it meets within rtol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core.config import ORBConfig as JORB
from stereo_semantic_vo_tpu.kernels.patch_extract import extract_patches as j_extract_patches
from stereo_semantic_vo_tpu.ops import orb as JO
from stereo_semantic_vo_tpu_torch.core.config import ORBConfig as TORB
from stereo_semantic_vo_tpu_torch.kernels import patch_extract as TP
from stereo_semantic_vo_tpu_torch.ops import orb as TO
from tests.torch_parity import n, t

R = 15
P = 2 * R + 1


def _levels(seed=0, shape=(96, 320), n_levels=3):
    """A 3-level pyramid of a random image, as extract_orb builds it."""
    img = np.random.RandomState(seed).uniform(0, 255, shape).astype(np.float32)
    return [n(x) for x in TO.pyramid(t(img), TORB(n_levels=n_levels))]


def _origins(shape, count, seed):
    """Clamped top-left origins, the four corner clamps first."""
    H, W = shape
    rng = np.random.RandomState(seed)
    y0 = np.r_[0, 0, H - P, H - P, rng.randint(0, H - P + 1, count - 4)].astype(np.int32)
    x0 = np.r_[0, W - P, 0, W - P, rng.randint(0, W - P + 1, count - 4)].astype(np.int32)
    return y0, x0


@pytest.mark.parametrize("seed,counts", [(0, (48, 32, 16)), (1, (16, 40, 24)), (2, (20, 0, 36))])
def test_levels_plain_matches_pallas_interpret(seed, counts):
    imgs = _levels(seed)
    assert [x.shape for x in imgs] == [(96, 320), (80, 267), (67, 222)]
    ys, xs, want = [], [], []
    for level, (img, k) in enumerate(zip(imgs, counts)):
        y0, x0 = _origins(img.shape, max(k, 4), seed + level)
        y0, x0 = y0[:k], x0[:k]
        ys.append(y0)
        xs.append(x0)
        if k:
            slab = j_extract_patches(jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), R)
            want.append(n(slab)[:, :P, :P])
    got = n(TP.extract_patches_levels([t(x) for x in imgs], t(np.concatenate(ys)), t(np.concatenate(xs)),
                                      counts, R))
    assert got.shape == (sum(counts), P, P)
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_one_level_entry_is_the_levels_entry():
    img = _levels(3)[0]
    y0, x0 = _origins(img.shape, 30, 3)
    one = TP.extract_patches(t(img), t(y0), t(x0), R)
    assert torch.equal(one, TP.extract_patches_levels([t(img)], t(y0), t(x0), [30], R))
    assert torch.equal(one, TP.extract_patches_plain(t(img), t(y0), t(x0), R))


def test_levels_entry_checks_its_arguments():
    imgs = [t(x) for x in _levels(4)]
    y0 = t(np.zeros(6, np.int32))
    with pytest.raises(ValueError, match="one count each"):
        TP.extract_patches_levels(imgs, y0, y0, [2, 4], R)
    before = TP.extract_patches_levels.launches
    out = TP.extract_patches_levels(imgs, y0, y0, [2, 4, 0], R)
    assert out.shape == (6, P, P) and TP.extract_patches_levels.launches == before  # CPU: plain version


def _orb_per_level(image, cfg):
    """extract_orb as the port computed it before one patch call a frame:
    one patch gather and one BRIEF pass at each level."""
    calls = []
    extract, describe = TO.extract_patches_levels_plain, TO._describe_upright

    def per_level(imgs, y0, x0, counts, r):
        ys, xs = torch.split(y0, counts), torch.split(x0, counts)
        calls.append(len(imgs))
        return [TP.extract_patches_plain(img, y, x, r) for img, y, x in zip(imgs, ys, xs)]

    def describe_each(patches, *args):
        return torch.cat([describe(p, *args) for p in patches])

    TO.extract_patches_levels_plain, TO._describe_upright = per_level, describe_each
    try:
        return TO.extract_orb(image, cfg), calls
    finally:
        TO.extract_patches_levels_plain, TO._describe_upright = extract, describe


@pytest.mark.parametrize("patch_backend", ["xla", "pallas"])
def test_extract_orb_one_patch_call_matches_per_level_and_jax(patch_backend):
    img = np.random.RandomState(5).uniform(0, 255, (96, 320)).astype(np.float32)
    cj = JORB(max_keypoints=128, n_levels=3, steer=False, patch_backend="xla")
    ct = TORB(**dataclasses.asdict(dataclasses.replace(cj, patch_backend=patch_backend)))
    kt = TO.extract_orb(t(img), ct)
    ref, calls = _orb_per_level(t(img), dataclasses.replace(ct, patch_backend="xla"))
    assert calls == [3]
    for name, a, b in zip(kt._fields, kt, ref):
        assert torch.equal(a, b), name
    kj = JO.extract_orb(jnp.asarray(img), cj)
    for f in ("uv", "valid", "level"):
        np.testing.assert_array_equal(n(getattr(kt, f)), n(getattr(kj, f)), err_msg=f)
    np.testing.assert_array_equal(n(kt.desc).view(np.uint32), n(kj.desc))
    # FAST responses on the resized levels inherit the resize's last-bit
    # differences (test_torch_orb_patches.py: 1e-4 grey levels)
    np.testing.assert_allclose(n(kt.response), n(kj.response), rtol=1e-6, atol=0)
