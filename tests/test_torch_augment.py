"""PyTorch port's ``models/augment`` against the JAX package's, on the CPU.

The port keeps its own numpy copy of the module: the same ``RandomState``
draws must give bit-equal images, truths, masks and leave the generator in
the same state."""

import numpy as np
import pytest

from stereo_semantic_vo_tpu.models import augment as JA
from stereo_semantic_vo_tpu_torch.models import augment as TA


def _batch(seed, B=3, H=48, W=64, T=5):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(B, H, W, 3).astype(np.float32)
    imgs[0, 10:30, 20:40] = 1.0
    imgs[1] = imgs[1, :, :, :1]  # gray: channels equal
    t = np.zeros((B, T, 5), np.float32)
    t[..., :2] = rng.uniform(0.1, 0.9, (B, T, 2))
    t[..., 2:4] = rng.uniform(0.02, 0.5, (B, T, 2))
    t[..., 4] = rng.randint(0, 3, (B, T))
    m = rng.rand(B, T) < 0.7
    return imgs, t, m


def _same_state(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


def test_rand_scale_bit_equal():
    ra, rb = np.random.RandomState(1), np.random.RandomState(1)
    for s in (0.5, 1.0, 1.5, 3.0):
        for _ in range(50):
            assert TA.rand_scale(ra, s) == JA.rand_scale(rb, s)
    _same_state(ra, rb)


@pytest.mark.parametrize("hue,sat,exp", [(0.1, 1.5, 1.5), (0.0, 1.0, 1.4), (0.5, 3.0, 0.8)])
def test_distort_hsv_bit_equal(hue, sat, exp):
    imgs, _, _ = _batch(2)
    ra, rb = np.random.RandomState(3), np.random.RandomState(3)
    for img in imgs:
        got = TA.distort_hsv(img, ra, hue, sat, exp)
        want = JA.distort_hsv(img, rb, hue, sat, exp)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    _same_state(ra, rb)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [
    {},
    {"jitter": 0.15, "hue": 0.0, "saturation": 1.0, "exposure": 1.4},  # the replay tool's draw
    {"jitter": 0.4, "flip": False},
])
def test_augment_detection_bit_equal(seed, kw):
    imgs, t, m = _batch(seed)
    ra, rb = np.random.RandomState(seed), np.random.RandomState(seed)
    for i in range(len(imgs)):
        got = TA.augment_detection(imgs[i], t[i], m[i], ra, **kw)
        want = JA.augment_detection(imgs[i], t[i], m[i], rb, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    _same_state(ra, rb)


def test_augment_batch_bit_equal():
    imgs, t, m = _batch(11, B=6)
    ra, rb = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(2):  # two epochs from one generator, as the replay tool draws them
        got = TA.augment_batch(imgs, t, m, ra, jitter=0.15, hue=0.0, saturation=1.0, exposure=1.4)
        want = JA.augment_batch(imgs, t, m, rb, jitter=0.15, hue=0.0, saturation=1.0, exposure=1.4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    _same_state(ra, rb)
