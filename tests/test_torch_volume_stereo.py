"""PyTorch port, the whole-image sparse stereo modes "volume" and "volume2"
against the JAX package, and against the port's "strips".

Tolerances, and why:
- against the JAX modes: valid masks equal, disparity within 1e-4 px,
  depth rtol 1e-5, best cost rtol 1e-5 (the same float32 terms, box-summed
  in the same window order; the JAX "volume" scan may round a fused term
  differently);
- "volume2" against the port's "volume": equal (the same elementwise
  terms, one volume at once against one disparity at a time);
- "volume" against "strips" on ORB keypoints whose right strip is not
  clamped (x >= D - 1 + r): valid equal, disparity within 1e-4 px.  Every
  ORB keypoint keeps its window inside the image (border 19 > r = 3), so
  the modes differ there only in summation order (separable box sums
  against whole-window sums).  Where the strip is clamped at the left
  edge, "strips" (the JAX package's, and so the port's and its kernel's)
  reads its cost for disparity d at disparity d - shift: the costs agree
  with "volume"'s shifted by ``shift`` within rtol 1e-5, and the
  disparities differ (ROADMAP C);
- the CPU's "auto" stays "strips" (the JAX package's picks "volume")."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core.camera import Camera as JCam
from stereo_semantic_vo_tpu.ops.stereo import sparse_disparity as j_sparse
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.kernels import sparse_stereo as SS
from stereo_semantic_vo_tpu_torch.ops import orb as TO
from stereo_semantic_vo_tpu_torch.ops import stereo as TS
from tests.test_tracker import CFG, render
from tests.torch_parity import n, t, one_torch_thread  # noqa: F401 (autouse fixture)

TCFG = interop.config_from_jax(CFG)


def _frame(i=1):
    return tuple(np.array(a) for a in render(i))


def _keypoints(H, W, K=128, seed=0):
    """Random keypoints with the image's corners, both edges' disparity
    range and half-pixel coordinates (round half to even)."""
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    uv[:8] = [[0, 0], [W - 1, H - 1], [3, 100], [40.5, 60.5], [41.5, 61.5], [W - 2, 5], [20.5, 200], [53, 130]]
    return uv, rng.rand(K) > 0.1


def _port(left, right, uv, valid, mode):
    cfg = dataclasses.replace(TCFG.stereo, sparse_mode=mode)
    return TS.sparse_disparity(t(left), t(right), t(uv), t(valid), TCam.from_config(TCFG.camera, "cpu"), cfg)


@pytest.mark.parametrize("mode", ["volume", "volume2"])
def test_volume_modes_match_jax(mode):
    left, right = _frame()
    uv, valid = _keypoints(*left.shape)
    a = j_sparse(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(valid),
                 JCam.from_config(CFG.camera), dataclasses.replace(CFG.stereo, sparse_mode=mode))
    b = _port(left, right, uv, valid, mode)
    np.testing.assert_array_equal(n(b.valid), n(a.valid))
    assert n(a.valid).sum() > 60
    np.testing.assert_allclose(n(b.disparity), n(a.disparity), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(b.depth), n(a.depth), rtol=1e-5)
    np.testing.assert_allclose(n(b.cost), n(a.cost), rtol=1e-5)


def test_volume2_equals_volume():
    left, right = _frame(2)
    uv, _ = _keypoints(*left.shape, seed=1)
    a = TS.volume_costs(t(left), t(right), t(uv), TCFG.stereo)
    b = TS.volume_costs(t(left), t(right), t(uv), TCFG.stereo, stacked=True)
    assert torch.equal(a, b)
    assert bool((a[:2] == TS.BIG).any())  # the corner keypoint's disparities the image cannot address


def test_volume_matches_strips_on_orb_keypoints():
    left, right = _frame(1)
    sc = TCFG.stereo
    D, r = sc.max_disparity, sc.block_radius
    kp = TO.extract_orb(t(left), TCFG.orb)
    cam = TCam.from_config(TCFG.camera, "cpu")
    out = {m: TS.sparse_disparity(t(left), t(right), kp.uv, kp.valid, cam,
                                  dataclasses.replace(sc, sparse_mode=m)) for m in ("volume", "strips")}
    v, s = out["volume"], out["strips"]
    shift = SS.keypoint_origins(kp.uv, *left.shape, D, r)[3]
    inside = shift == 0
    assert int((s.valid & inside).sum()) > 100
    assert torch.equal(v.valid[inside], s.valid[inside])
    np.testing.assert_allclose(n(v.disparity[inside]), n(s.disparity[inside]), rtol=0, atol=1e-4)
    # the clamped strips: "strips" costs at d are "volume"'s at d - shift
    vol = TS.volume_costs(t(left), t(right), kp.uv, sc)
    y0, xl0, xr0, _ = SS.keypoint_origins(kp.uv, *left.shape, D, r)
    acc = SS.keypoint_stereo_costs_plain(t(left), t(right), y0, xl0, xr0, D, r, sc.color_weight, sc.grad_weight,
                                         sc.color_trunc, sc.grad_trunc)
    edge = torch.nonzero(~inside).flatten().tolist()
    assert len(edge) >= 10
    for k in edge:
        sh = int(shift[k])
        np.testing.assert_allclose(n(torch.flip(acc[k], (0,))[sh:]), n(vol[k, : D - sh]), rtol=1e-5)
        assert bool((vol[k, D - sh :] == TS.BIG).all())
    assert not torch.equal(v.disparity[~inside], s.disparity[~inside])


def test_box_sum_is_the_reference_window_sum():
    """``box_sum`` of an integer image (exact float sums) against the
    direct zero-padded P x P window sum."""
    img = np.random.RandomState(4).randint(0, 255, (20, 31)).astype(np.float32)
    want = np.zeros_like(img)
    pad = np.pad(img, 3)
    for dy in range(7):
        for dx in range(7):
            want += pad[dy : dy + 20, dx : dx + 31]
    np.testing.assert_array_equal(n(TS.box_sum(t(img), 7)), want)


def test_cpu_auto_stays_strips():
    left, right = _frame()
    uv, valid = _keypoints(*left.shape)
    a, b = _port(left, right, uv, valid, "auto"), _port(left, right, uv, valid, "strips")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_unknown_mode_raises():
    left, right = _frame()
    uv, valid = _keypoints(*left.shape, K=16)
    with pytest.raises(ValueError, match="unknown sparse_mode"):
        _port(left, right, uv, valid, "voxels")
