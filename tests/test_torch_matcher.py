"""PyTorch port, Hamming distances and kernel 3 (fused matcher) against the
JAX package, integer-exact on all three outputs (idx included).

The JAX side runs its Pallas matcher in interpret mode; the cases follow
tests/test_fused_matcher.py (random with masks, all-invalid queries,
planted exact matches) plus duplicated train rows (ties to the lower idx).

``_emulate_kernel`` repeats csrc/matcher.cu's arithmetic in numpy: the
train set in 32 strided slices (one a lane), each slice's (best, second)
codes, then the lanes' butterfly merge in the kernel's order.  It is held
equal to ``masked_best_match`` and to JAX's fused matcher on ties within
and across slices, all-masked rows and train sizes around the warp width."""

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


INT_MAX = 2**31 - 1


def _emulate_kernel(q, tr, qv, tv):
    """csrc/matcher.cu in numpy: lane l walks train rows l, l + 32, ... in
    order and keeps second = min(second, max(best, code)), best =
    min(best, code); a butterfly over lane masks 16, 8, 4, 2, 1 merges the
    pairs with second = min(max(b, b'), min(s, s')), best = min(b, b')."""
    Q, T = len(q), len(tr)
    dist = np.where(qv[:, None] & tv[None, :], numpy_hamming(q, tr), 257).astype(np.int64)
    code = dist * T + np.arange(T)
    best = np.full((Q, 32), INT_MAX, np.int64)
    second = best.copy()
    for r in range(T):
        lane = r % 32
        second[:, lane] = np.minimum(second[:, lane], np.maximum(best[:, lane], code[:, r]))
        best[:, lane] = np.minimum(best[:, lane], code[:, r])
    for m in (16, 8, 4, 2, 1):
        partner = np.arange(32) ^ m
        ob, os_ = best[:, partner], second[:, partner]
        second = np.minimum(np.maximum(best, ob), np.minimum(second, os_))
        best = np.minimum(best, ob)
    assert (best == best[:, :1]).all() and (second == second[:, :1]).all()  # every lane holds the result
    b, s = best[:, 0], second[:, 0]
    return (b % T).astype(np.int32), (b // T).astype(np.int32), np.where(s == INT_MAX, 257, s // T).astype(np.int32)


def _slice_case(name, T, seed, Q=70):
    rng = np.random.RandomState(seed)
    q, tr = random_desc(rng, Q), random_desc(rng, T)
    qv, tv = rng.rand(Q) > 0.2, rng.rand(T) > 0.2
    expect = {}
    if name == "ties" and T >= 3:
        tr[2] = tr[1]  # across slices: lanes 1 and 2
        q[0] = tr[1]
        qv[0], tv[1:3] = True, True
        expect[0] = 1
        if T > 32:  # within a slice: rows T-33 and T-1 are both lane (T-1) % 32
            tr[T - 1] = tr[T - 33]
            q[1] = tr[T - 1]
            qv[1], tv[T - 33], tv[T - 1] = True, True, True
            expect[1] = T - 33
    elif name == "all_masked":
        tv[:] = False  # every pair masked: (0, 257, 257)
    return q, tr, qv, tv, expect


@pytest.mark.parametrize("T", [1, 31, 33, 512, 517])
@pytest.mark.parametrize("name", ["random", "ties", "all_masked"])
def test_kernel_merge_matches_plain_and_fused_interpret(name, T):
    q, tr, qv, tv, expect = _slice_case(name, T, seed=T)
    got = _emulate_kernel(q, tr, qv, tv)
    plain = TH.masked_best_match(t(numpy_hamming(q, tr)), t(qv), t(tv))
    want = j_match(jnp.asarray(q), jnp.asarray(tr), jnp.asarray(qv), jnp.asarray(tv))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, n(p))
        np.testing.assert_array_equal(g, n(w))
    for query, idx in expect.items():
        assert got[0][query] == idx and got[1][query] == 0 and got[2][query] == 0
    if name == "all_masked" or T == 1:
        assert (got[2] == 257).all()
    if name == "all_masked":
        assert (got[0] == 0).all() and (got[1] == 257).all()
