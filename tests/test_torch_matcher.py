"""PyTorch port, Hamming distances and kernel 3 (fused matcher) against the
JAX package, integer-exact on all three outputs (idx included).

The JAX side runs its Pallas matcher in interpret mode; the cases follow
tests/test_fused_matcher.py (random with masks, all-invalid queries,
planted exact matches) plus duplicated train rows (ties to the lower idx)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.kernels import hamming as JH
from stereo_semantic_vo_tpu.kernels.matcher import fused_best_match as j_match
from stereo_semantic_vo_tpu_torch.kernels import hamming as TH
from stereo_semantic_vo_tpu_torch.kernels import matcher as TM
from tests.test_hamming import numpy_hamming
from tests.torch_parity import n, random_desc, t


def _case(name, Q, T, seed):
    rng = np.random.RandomState(seed)
    q, tr = random_desc(rng, Q), random_desc(rng, T)
    qv, tv = np.arange(Q) % 5 != 0, np.arange(T) % 7 != 0
    if name == "all_invalid":
        qv = np.zeros(Q, bool)
    elif name == "exact":
        tr[T - 8 :] = q[:8]
        qv, tv = np.ones(Q, bool), np.ones(T, bool)
    elif name == "duplicates":
        tr[9] = tr[4]
        q[3] = tr[4]
        tv[:] = True
    return q, tr, qv, tv


def test_hamming_matches_numpy():
    rng = np.random.RandomState(0)
    q, tr = random_desc(rng, 64), random_desc(rng, 96)
    np.testing.assert_array_equal(n(TH.hamming_distance_matrix(t(q), t(tr))), numpy_hamming(q, tr))
    np.testing.assert_array_equal(
        n(TH.hamming_distance_matrix(t(q), t(tr))), n(JH.hamming_distance_matrix(jnp.asarray(q), jnp.asarray(tr)))
    )


def test_hamming_matrix_plain_matches_pallas_interpret():
    """Kernel 8: the plain version is the full-matrix kernel's contract."""
    rng = np.random.RandomState(8)
    q, tr = random_desc(rng, 300), random_desc(rng, 200)
    tr[17] = q[5]  # an exact match: distance 0
    want = n(JH.hamming_distance_matrix_pallas(jnp.asarray(q), jnp.asarray(tr)))
    before = TH.hamming_distance_matrix_pallas.launches
    got = n(TH.hamming_distance_matrix_pallas(t(q), t(tr)))
    assert TH.hamming_distance_matrix_pallas.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == np.int32 and got.shape == (300, 200) and got[5, 17] == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "name,Q,T",
    [("random", 256, 512), ("random", 512, 128), ("all_invalid", 128, 128),
     ("exact", 128, 128), ("duplicates", 64, 128)],
)
def test_plain_matches_fused_interpret(name, Q, T):
    q, tr, qv, tv = _case(name, Q, T, seed=Q + T)
    want = j_match(jnp.asarray(q), jnp.asarray(tr), jnp.asarray(qv), jnp.asarray(tv))
    got = TM.fused_best_match(t(q), t(tr), t(qv), t(tv))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), n(w))
    if name == "all_invalid":
        assert (n(got[1]) == 257).all() and (n(got[2]) == 257).all() and (n(got[0]) == 0).all()
    if name == "exact":
        np.testing.assert_array_equal(n(got[0])[:8], np.arange(T - 8, T))
        np.testing.assert_array_equal(n(got[1])[:8], 0)
    if name == "duplicates":
        assert n(got[0])[3] == 4 and n(got[1])[3] == 0 and n(got[2])[3] == 0


def test_masked_best_match_matches_jax():
    rng = np.random.RandomState(5)
    dist = rng.randint(0, 40, (50, 30)).astype(np.int32)  # many ties
    qv, tv = rng.rand(50) > 0.2, rng.rand(30) > 0.2
    want = JH.masked_best_match(jnp.asarray(dist), jnp.asarray(qv), jnp.asarray(tv))
    got = TH.masked_best_match(t(dist), t(qv), t(tv))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), n(w))
