"""PyTorch port, ``ops/triangulation`` against the JAX package.

Tolerances: valid masks equal; points within rtol 1e-4 of their norm
(|dX| <= 1e-4 |X|).  Both solve the same 4x4 normal matrix by shifted
inverse iteration in float32, with another summation order and another
Cholesky; the iteration's last bits differ, and a far point's depth
carries them.  The single-landmark form is the batch's first column."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core import Camera, CameraConfig, lie
from stereo_semantic_vo_tpu.ops.triangulation import triangulate as j_tri
from stereo_semantic_vo_tpu.ops.triangulation import triangulate_batch as j_tri_batch
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.core.config import CameraConfig as TCC
from stereo_semantic_vo_tpu_torch.ops import triangulation as TT
from tests.torch_parity import n, t, one_torch_thread  # noqa: F401 (autouse fixture)

CAM_CFG = CameraConfig()
JCAM = Camera.from_config(CAM_CFG)
TCAM = TCam.from_config(TCC(), "cpu")


def _problem(F=4, L=200, noise=0.5, seed=0):
    """Landmarks 4-40 m ahead, seen from F poses 0.6 m apart along x with
    small random turns, noisy pixels; ~30% of the views masked, some
    landmarks seen once, one behind the cameras."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-10, 10, L), rng.uniform(-3, 3, L), rng.uniform(4, 40, L)], -1).astype(np.float32)
    twists = rng.normal(0, [0.05, 0.05, 0.1, 0.01, 0.03, 0.01], (F, 6)).astype(np.float32)
    twists[:, 0] += 0.6 * np.arange(F)
    twists[0] = 0.0
    poses = np.stack([n(lie.se3_exp(jnp.asarray(w))) for w in twists])
    X[7] = [0.0, 0.0, -5.0]  # behind every camera
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    c = CAM_CFG
    uv = np.stack([c.fx * pc[..., 0] / pc[..., 2] + c.cx, c.fy * pc[..., 1] / pc[..., 2] + c.cy], -1)
    uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    mask = rng.rand(F, L) > 0.3
    mask[:, :5] = False
    mask[0, :5] = True  # seen once: invalid
    return poses, uv, mask


@pytest.mark.parametrize("F,noise", [(2, 0.0), (4, 0.5)])
def test_triangulate_batch_matches_jax(F, noise):
    poses, uv, mask = _problem(F=F, noise=noise)
    Xj, vj = (n(a) for a in j_tri_batch(jnp.asarray(poses), jnp.asarray(uv), jnp.asarray(mask), JCAM))
    Xt, vt = (n(a) for a in TT.triangulate_batch(t(poses), t(uv), t(mask), TCAM))
    np.testing.assert_array_equal(vt, vj)
    assert 0.3 * len(vj) < vj.sum() < len(vj) and not vj[:5].any() and not vj[7]
    err = np.linalg.norm(Xt[vj] - Xj[vj], axis=1) / np.linalg.norm(Xj[vj], axis=1)
    assert err.max() <= 1e-4, err.max()


def test_triangulate_one_landmark_matches_jax():
    poses, uv, mask = _problem()
    for k in (5, 6, 8, 7, 0):  # valid ones, the point behind, a single view
        Xj, vj = j_tri(jnp.asarray(poses), jnp.asarray(uv[:, k]), jnp.asarray(mask[:, k]), JCAM)
        Xt, vt = TT.triangulate(t(poses), t(uv[:, k]), t(mask[:, k]), TCAM)
        assert bool(vt) == bool(vj)
        if bool(vj):
            assert np.linalg.norm(n(Xt) - n(Xj)) <= 1e-4 * np.linalg.norm(n(Xj))


def test_exact_recovery_and_masked_views():
    """tests/test_triangulation.py's cases on the port: noise-free views
    give the point back; a masked view with a wild pixel is ignored."""
    X = np.array([2.0, -1.0, 15.0], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32),
                      n(lie.se3_exp(jnp.array([0.5, 0.0, 0.0, 0.0, 0.02, 0.0]))),
                      n(lie.se3_exp(jnp.array([1.0, 0.1, -0.3, 0.0, 0.04, 0.0])))])
    pc = np.einsum("fij,j->fi", poses[:, :3, :3], X) + poses[:, :3, 3]
    uv = np.stack([CAM_CFG.fx * pc[:, 0] / pc[:, 2] + CAM_CFG.cx, CAM_CFG.fy * pc[:, 1] / pc[:, 2] + CAM_CFG.cy], -1)
    uv = uv.astype(np.float32)
    Xt, vt = TT.triangulate(t(poses), t(uv), t(np.ones(3, bool)), TCAM)
    assert bool(vt)
    np.testing.assert_allclose(n(Xt), X, atol=1e-3)
    uv[2] = 9999.0
    Xt, vt = TT.triangulate(t(poses), t(uv), t(np.array([True, True, False])), TCAM)
    assert bool(vt)
    np.testing.assert_allclose(n(Xt), X, atol=1e-3)
