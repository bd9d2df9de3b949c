"""PyTorch port, RANSAC's draws against the JAX package.

The reference draws each frame's (B, S) sample indices as the Gumbel top-k
under ``fold_in(PRNGKey(cfg.pnp.seed), t)``; the port computes the same
threefry-2x32 bits with integer ops on the device, so the draws are a pure
function of ``(seed, t)``: equal to JAX's (exact: on these inputs no two
uniforms tie), equal whatever was drawn before, and the same for a frame
counter on the device as for the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.ops import pnp as JP
from stereo_semantic_vo_tpu_torch.ops import pnp as TP

B, S, K = 256, 6, 512


def _valid(kind: str, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "all":
        return np.ones(K, bool)
    if kind == "few":  # fewer valid than a sample: masked entries fill it
        v = np.zeros(K, bool)
        v[rng.choice(K, 4, replace=False)] = True
        return v
    return rng.rand(K) < 0.3


def _jax_draws(seed: int, t: int | None, valid: np.ndarray, b: int = B, s: int = S) -> np.ndarray:
    key = jax.random.PRNGKey(seed)
    if t is not None:
        key = jax.random.fold_in(key, t)
    return np.asarray(JP._sample_indices(key, jnp.asarray(valid), b, s))


def _draws(seed: int, t: int | None, valid: np.ndarray, b: int = B, s: int = S) -> np.ndarray:
    counter = None if t is None else torch.tensor(t, dtype=torch.int32)
    return TP.sample_indices(TP.random_key(seed, counter), torch.from_numpy(valid), b, s).numpy()


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
@pytest.mark.parametrize("t", [None, 0, 1, 5, 4097])
def test_keys_equal_jax(seed, t):
    want = jax.random.PRNGKey(seed)
    if t is not None:
        want = jax.random.fold_in(want, t)
    got = TP.random_key(seed, None if t is None else torch.tensor(t, dtype=torch.int32))
    assert [int(x) for x in got] == [int(x) for x in np.asarray(jax.random.key_data(want))]


@pytest.mark.parametrize("kind", ["all", "random", "few"])
@pytest.mark.parametrize("t", [None, 0, 3, 17, 250])
def test_draws_equal_jax(kind, t):
    valid = _valid(kind, 0 if t is None else t)
    np.testing.assert_array_equal(_draws(7, t, valid), _jax_draws(7, t, valid))


def test_uniform_bits_equal_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bits(key, (4, 9))).astype(np.int64)
    count = torch.arange(36, dtype=torch.int64).reshape(4, 9)
    k = TP.random_key(3, torch.tensor(11))
    b0, b1 = TP._threefry2x32(*k, torch.zeros_like(count), count)
    np.testing.assert_array_equal((b0 ^ b1).numpy(), want)


def test_draws_do_not_depend_on_what_was_drawn_before():
    valid = _valid("random", 1)
    first = _draws(5, 9, valid)
    for t in (0, 1, 2, 10, 9, 3):
        _draws(5, t, valid)
    torch.rand(100)  # and nothing of torch's default generator
    np.testing.assert_array_equal(_draws(5, 9, valid), first)
    assert not np.array_equal(_draws(5, 10, valid), first)


def test_draws_are_distinct_valid_indices():
    valid = _valid("random", 2)
    idx = _draws(0, 4, valid)
    assert idx.shape == (B, S)
    assert all(len(set(row)) == S for row in idx)
    assert valid[idx].all()


def test_ransac_draws_under_the_frame_counter_equal_jax_draws():
    """``ransac_pnp(t=...)`` draws what the explicit indices of JAX's key give."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.core.config import CameraConfig, PnPConfig

    rng = np.random.RandomState(0)
    X = np.concatenate([rng.uniform(-5, 5, (K, 2)), rng.uniform(5, 30, (K, 1))], 1).astype(np.float32)
    cam = Camera.from_config(CameraConfig(), "cpu")
    uv = np.stack([X[:, 0] / X[:, 2] * float(cam.fx) + float(cam.cx),
                   X[:, 1] / X[:, 2] * float(cam.fy) + float(cam.cy)], 1).astype(np.float32)
    valid = _valid("random", 3)
    cfg = PnPConfig(seed=11)
    args = (torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(valid), cam, cfg)
    idx = _jax_draws(11, 6, valid, cfg.num_hypotheses, cfg.sample_size)
    a = TP.ransac_pnp(*args, t=torch.tensor(6, dtype=torch.int32))
    b = TP.ransac_pnp(*args, idx=torch.from_numpy(np.array(idx)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
