"""PyTorch port, kernel 4 (FAST scores) against the JAX package.

The JAX side runs ``fast_scores_pallas`` in interpret mode.  Its contract is
a zero halo at the image edge, and the plain version (the rolled ring on the
image zero-padded by 3 px) is bit-equal to it on the whole map; both equal
the reference's rolled ring (``ops/orb._fast_score``, which wraps around)
on ``[3:-3, 3:-3]``.  ``extract_orb(fast_backend="pallas")`` is
bit-identical to JAX's at one level and has >= 99% identical slots at
three, the criterion of tests/test_torch_orb_patches.py.

``fast_scores_levels`` (all levels, border mask and 3x3 NMS in one launch
on the card) is held to the JAX composition in ``extract_orb``'s Pallas
branch, ``_nms3(where(border_mask, fast_scores_pallas(img_l, ths)[j], 0))``,
bit for bit, and ``extract_orb(fast_backend="pallas")`` makes one such call
a frame."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.config import ORBConfig as JORB
from stereo_semantic_vo_tpu.kernels.fast_score import fast_scores_pallas
from stereo_semantic_vo_tpu.ops import orb as JO
from stereo_semantic_vo_tpu_torch.core.config import ORBConfig as TORB
from stereo_semantic_vo_tpu_torch.kernels import fast_score as TF
from stereo_semantic_vo_tpu_torch.ops import orb as TO
from tests.test_fast_pallas import synth
from tests.torch_parity import n, t


def _image(kind, H, W):
    if kind == "synth":  # tests/test_fast_pallas.py's blocks on black
        return n(synth(3 if (H, W) == (97, 307) else 0, H=H, W=W))
    # texture up to the edge: corners on the border rows and columns
    return np.random.RandomState(H + W).uniform(0, 255, (H, W)).astype(np.float32)


@pytest.mark.parametrize(
    "kind,H,W,ths",
    [("synth", 120, 200, (20.0, 7.0)), ("synth", 97, 307, (20.0,)), ("texture", 40, 150, (20.0, 7.0))],
)
def test_plain_matches_pallas_interpret(kind, H, W, ths):
    img = _image(kind, H, W)
    want = fast_scores_pallas(jnp.asarray(img), ths)
    got = TF.fast_scores_plain(t(img), ths)
    assert len(got) == len(ths)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), n(w))  # the whole map, halo included
    for g, r in zip(got, JO._fast_score(jnp.asarray(img), *ths)):
        np.testing.assert_array_equal(n(g)[3:-3, 3:-3], n(r)[3:-3, 3:-3])
    if kind == "texture":  # the zero halo differs from the wrap at the edge
        assert any((n(g)[:3] != n(r)[:3]).any() for g, r in zip(got, JO._fast_score(jnp.asarray(img), *ths)))


def test_cpu_wrapper_takes_plain_version():
    img = t(_image("texture", 40, 150))
    before = TF.fast_scores_levels.launches  # fast_scores counts there
    got = TF.fast_scores(img, (20.0, 7.0))
    assert TF.fast_scores_levels.launches == before  # no kernel launch for a CPU tensor
    for a, b in zip(got, TF.fast_scores_plain(img, (20.0, 7.0))):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.fixture(scope="module")
def img():
    return np.random.RandomState(3).uniform(0, 255, (120, 400)).astype(np.float32)


def _orb_pair(img, levels):
    cj = JORB(max_keypoints=128, n_levels=levels, steer=False, patch_backend="xla", fast_backend="pallas")
    ct = TORB(**dataclasses.asdict(dataclasses.replace(cj, patch_backend="auto")))
    return JO.extract_orb(jnp.asarray(img), cj), TO.extract_orb(t(img), ct)


def test_extract_orb_pallas_one_level_equal(img):
    kj, kt = _orb_pair(img, 1)
    for f in ("uv", "valid", "level", "response", "angle"):
        np.testing.assert_array_equal(n(getattr(kt, f)), n(getattr(kj, f)), err_msg=f)
    np.testing.assert_array_equal(n(kt.desc).view(np.uint32), n(kj.desc))
    # and the 19-px border mask hides the halo: the same keypoints as "xla"
    xla = TO.extract_orb(t(img), TORB(max_keypoints=128, n_levels=1, steer=False, patch_backend="auto"))
    for a, b in zip(kt, xla):
        np.testing.assert_array_equal(n(a), n(b))


def test_extract_orb_pallas_three_levels_agree(img):
    kj, kt = _orb_pair(img, 3)
    np.testing.assert_array_equal(n(kt.valid), n(kj.valid))
    same = (n(kt.uv) == n(kj.uv)).all(1) & (n(kt.desc).view(np.uint32) == n(kj.desc)).all(1)
    assert same[n(kj.valid)].mean() >= 0.99


def _jax_level_maps(img, ths, b):
    """The reference's composition at one level (stereo_semantic_vo_tpu/ops/orb.py:337-343)."""
    Hl, Wl = img.shape
    border_mask = jnp.zeros((Hl, Wl), bool).at[b : Hl - b, b : Wl - b].set(True)
    return [JO._nms3(jnp.where(border_mask, sc, 0.0)) for sc in fast_scores_pallas(jnp.asarray(img), ths)]


@pytest.mark.parametrize("border", [19, 40])
@pytest.mark.parametrize("ths", [(20.0, 7.0), (20.0,)])
def test_levels_plain_matches_jax_composition(border, ths):
    """A 3-level pyramid of an integer-valued texture (ties for the NMS) and
    a 60x70 level.  Border 40 leaves level 2 (83x139) a 3-row interior and
    covers the last level whole; border 19 is kitti()'s."""
    rng = np.random.RandomState(11)
    img = np.round(rng.uniform(0, 255, (120, 200))).astype(np.float32)
    img[30:70, 50:120] = 200.0  # a block: strong corners and flat plateaus
    cfg = TORB(max_keypoints=128, n_levels=3, steer=False)
    levels = [n(x) for x in TO.pyramid(t(img), cfg)]
    levels.append(np.round(rng.uniform(0, 255, (60, 70))).astype(np.float32))
    assert [x.shape for x in levels] == [(120, 200), (100, 167), (83, 139), (60, 70)]
    before = TF.fast_scores_levels.launches
    got = TF.fast_scores_levels([t(x) for x in levels], ths, border)
    assert TF.fast_scores_levels.launches == before  # a CPU tensor takes the plain version
    assert len(got) == len(levels)
    for level, (img_l, maps) in enumerate(zip(levels, got)):
        want = _jax_level_maps(img_l, ths, border)
        assert len(maps) == len(ths)
        for j, (g, w) in enumerate(zip(maps, want)):
            np.testing.assert_array_equal(n(g), n(w), err_msg=f"level {level}, threshold {j}")
    # the interiors: level 2's thin band holds corners, the last level none
    interior = n(got[2][0])[border : 83 - border, border : 139 - border]
    assert border != 40 or (interior.shape[0] == 3 and (interior > 0).any())
    assert border != 40 or not n(got[3][0]).any()
    # the NMS dropped some scores that were above 0
    raw = TF.fast_scores_plain(t(levels[0]), ths)[0]
    assert (n(raw)[border:-border, border:-border] > 0).sum() > (n(got[0][0]) > 0).sum() > 0


def test_levels_rejects_a_negative_border():
    with pytest.raises(ValueError, match="border"):
        TF.fast_scores_levels([t(np.zeros((40, 40), np.float32))], (20.0,), -1)


@pytest.mark.parametrize("levels", [1, 3])
def test_extract_orb_pallas_makes_one_levels_call_a_frame(img, levels, monkeypatch):
    calls = []

    def counted(imgs, ths, border):
        calls.append((len(imgs), ths, border))
        return TF.fast_scores_levels(imgs, ths, border)

    monkeypatch.setattr(TO, "fast_scores_levels", counted)
    kj, kt = _orb_pair(img, levels)
    assert calls == [(levels, (20.0, 7.0), 19)]
    xla = TO.extract_orb(t(img), TORB(max_keypoints=128, n_levels=levels, steer=False, patch_backend="auto"))
    assert len(calls) == 1  # the rolled ring ("xla") makes none
    for a, b in zip(kt, xla):  # bit-equal to the per-level route
        np.testing.assert_array_equal(n(a), n(b))
    # and to JAX's extract_orb(fast_backend="pallas"), by the criteria above
    np.testing.assert_array_equal(n(kt.valid), n(kj.valid))
    same = (n(kt.uv) == n(kj.uv)).all(1) & (n(kt.desc).view(np.uint32) == n(kj.desc)).all(1)
    assert same[n(kj.valid)].mean() >= (1.0 if levels == 1 else 0.99)
