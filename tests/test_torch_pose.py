"""PyTorch port, pose stack (epipolar, PnP, motion-only BA) against the JAX
package and the OpenCV goldens in tests/fixtures/cv/.

The PnP tests hand the port the reference's sample indices (the port's own
draws equal them: tests/test_torch_ransac_draws.py).  Tolerances: elementwise geometry rtol 1e-5;
poses 1e-4 (float32 solves in another order); the fundamental matrix is
compared through epipolar distances (0.02 px on exact data, median within
0.05 px on the 25%-outlier golden set)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core import lie as JL
from stereo_semantic_vo_tpu.core.camera import Camera as JCam
from stereo_semantic_vo_tpu.core.config import BAConfig, VOConfig
from stereo_semantic_vo_tpu.ops import ba as JB
from stereo_semantic_vo_tpu.ops import epipolar as JE
from stereo_semantic_vo_tpu.ops import pnp as JP
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.interop import config_from_jax
from stereo_semantic_vo_tpu_torch.ops import ba as TB
from stereo_semantic_vo_tpu_torch.ops import epipolar as TE
from stereo_semantic_vo_tpu_torch.ops import pnp as TP
from tests.test_cv_goldens import CV_DIR, _pose_errors
from tests.torch_parity import n, t

CFG = VOConfig.kitti("00")
TCFG = config_from_jax(CFG)
JC, TC = JCam.from_config(CFG.camera), TCam.from_config(TCFG.camera, "cpu")


def _pnp_data():
    lines = open(os.path.join(CV_DIR, "pnp_input.txt")).read().strip().split("\n")
    data = np.array([[float(x) for x in l.split()] for l in lines[1:]], np.float32)
    return data[:, :3], data[:, 3:5]


def _two_view(seed=0, N=200, noise=0.0):
    """Exact (or noisy) projections of one point cloud from two poses."""
    rng = np.random.RandomState(seed)
    X = rng.uniform([-10, -2, 5], [10, 2, 40], (N, 3)).astype(np.float32)
    T2 = n(JL.se3_exp(jnp.asarray([0.3, 0.01, 0.9, 0.01, -0.02, 0.005], jnp.float32)))

    def proj(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([CFG.camera.fx * pc[:, 0] / pc[:, 2] + CFG.camera.cx,
                       CFG.camera.fy * pc[:, 1] / pc[:, 2] + CFG.camera.cy], -1)
        return (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)

    return X, T2, proj(np.eye(4, dtype=np.float32)), proj(T2)


def test_fit_fundamental_exact_data():
    _, _, uv1, uv2 = _two_view()
    w = np.ones(len(uv1), np.float32)
    dj = n(JE.epipolar_distance(JE.fit_fundamental(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(w)),
                                jnp.asarray(uv1), jnp.asarray(uv2)))
    dt = n(TE.epipolar_distance(TE.fit_fundamental(t(uv1), t(uv2), t(w)), t(uv1), t(uv2)))
    assert dj.max() < 0.05 and dt.max() < 0.05
    np.testing.assert_allclose(dt, dj, rtol=0, atol=0.02)


def test_fit_fundamental_opencv_golden():
    pairs = np.loadtxt(os.path.join(CV_DIR, "fmat_input.txt")).astype(np.float32)
    uv1, uv2 = pairs[:, :2], pairs[:, 2:4]
    w = np.ones(len(pairs), np.float32)
    dj = n(JE.epipolar_distance(JE.fit_fundamental(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(w)),
                                jnp.asarray(uv1), jnp.asarray(uv2)))
    dt = n(TE.epipolar_distance(TE.fit_fundamental(t(uv1), t(uv2), t(w)), t(uv1), t(uv2)))
    g = open(os.path.join(CV_DIR, "fmat_golden.txt")).read().strip().split("\n")
    F_cv = np.array([[float(x) for x in g[i].split()] for i in range(3)], np.float32)
    d_cv = np.median(n(TE.epipolar_distance(t(F_cv), t(uv1), t(uv2))))
    assert np.median(dt) <= 1.5 * d_cv + 0.1 and np.median(dt) < 1.5
    assert abs(np.median(dt) - np.median(dj)) < 0.05


def test_epipolar_helpers_match_jax():
    _, T2, uv1, uv2 = _two_view(noise=0.5)
    F = np.random.RandomState(1).normal(0, 1, (3, 3)).astype(np.float32)
    for name in ("epipolar_distance", "sampson_distance"):
        want = n(getattr(JE, name)(jnp.asarray(F), jnp.asarray(uv1), jnp.asarray(uv2)))
        np.testing.assert_allclose(n(getattr(TE, name)(t(F), t(uv1), t(uv2))), want, rtol=1e-5)
    want = n(JE.fundamental_from_pose(jnp.asarray(T2), JC.K))
    np.testing.assert_allclose(n(TE.fundamental_from_pose(t(T2), TC.K)), want, rtol=1e-5, atol=1e-9)
    boxes = np.array([[100, 50, 300, 200], [500, 0, 700, 100], [0, 0, 1e4, 1e4]], np.float32)
    bv = np.array([True, True, False])
    np.testing.assert_array_equal(
        n(TE.in_box_mask(t(uv1), t(boxes), t(bv), 5.0)),
        n(JE.in_box_mask(jnp.asarray(uv1), jnp.asarray(boxes), jnp.asarray(bv), 5.0)),
    )


def test_smallest_eigvec_matches_jax():
    rng = np.random.RandomState(2)
    Q, _ = np.linalg.qr(rng.normal(size=(8, 12, 12)))
    ev = np.linspace(1e-3, 50, 12)
    M = (Q * ev[None, None, :]) @ np.swapaxes(Q, 1, 2)
    M = M.astype(np.float32)
    want = n(jax.vmap(JP.smallest_eigvec)(jnp.asarray(M)))
    got = n(TP.smallest_eigvec(t(M)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # not positive definite: NaN, not an exception
    bad = -np.eye(12, dtype=np.float32)[None]
    assert np.isnan(n(TP.smallest_eigvec(t(bad)))).all()


def test_dlt_pose_exact_sample():
    X, T2, _, uv2 = _two_view(N=6)
    xn = np.stack([(uv2[:, 0] - CFG.camera.cx) / CFG.camera.fx, (uv2[:, 1] - CFG.camera.cy) / CFG.camera.fy], -1)
    Tj = n(JP._P_to_T(JP._dlt_pose(jnp.asarray(X), jnp.asarray(xn))))
    Tt = n(TP._P_to_T(TP._dlt_pose(t(X), t(xn))))
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(Tt, T2, rtol=0, atol=2e-3)


@pytest.mark.parametrize("reflect", [False, True])
def test_P_to_T_matches_svd_form(reflect):
    # distinct singular values, so the direction a reflection flips is defined
    rng = np.random.RandomState(4)
    U = n(JL.so3_exp(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)))
    V = n(JL.so3_exp(jnp.asarray([-0.4, 0.2, 0.1], jnp.float32)))
    M3 = U @ np.diag([2.0, 1.7, 1.1 * (-1.0 if reflect else 1.0)]) @ V.T
    P = np.concatenate([M3, rng.normal(0, 3, (3, 1))], 1)
    P = P.astype(np.float32)
    np.testing.assert_allclose(n(TP._P_to_T(t(P))), n(JP._P_to_T(jnp.asarray(P))), rtol=0, atol=1e-5)


def test_ransac_pnp_with_reference_samples_matches_jax_and_opencv():
    X, uv = _pnp_data()
    valid = np.ones(len(X), bool)
    key = jax.random.PRNGKey(0)
    idx = n(JP._sample_indices(key, jnp.asarray(valid), CFG.pnp.num_hypotheses, CFG.pnp.sample_size))
    rj = JP.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), JC, CFG.pnp, key=key)
    rt = TP.ransac_pnp(t(X), t(uv), t(valid), TC, TCFG.pnp, idx=t(idx))
    np.testing.assert_allclose(n(rt.T_cw), n(rj.T_cw), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(rt.inlier_mask), n(rj.inlier_mask))
    assert bool(rt.ok) and int(rt.n_inliers) == int(rj.n_inliers)
    g = open(os.path.join(CV_DIR, "pnp_golden.txt")).read().strip().split("\n")
    R_cv = np.array([[float(x) for x in g[i].split()] for i in range(3)])
    ang_cv, te_cv = _pose_errors(R_cv, np.array([float(x) for x in g[3].split()]))
    T = n(rt.T_cw).astype(np.float64)
    ang, te = _pose_errors(T[:3, :3], T[:3, 3])
    assert ang <= max(2.0 * ang_cv, 0.05) and te <= max(2.0 * te_cv, 0.01)


def test_ransac_pnp_own_sampler_and_seed():
    X, uv = _pnp_data()
    valid = torch.ones(len(X), dtype=torch.bool)
    r = TP.ransac_pnp(t(X), t(uv), valid, TC, dataclasses.replace(TCFG.pnp, seed=123), t=torch.tensor(5))
    assert bool(r.ok) and int(r.n_inliers) >= 150


def test_ransac_pnp_too_few_correspondences():
    X, uv = _pnp_data()
    valid = np.zeros(len(X), bool)
    valid[:4] = True  # fewer than sample_size: degenerate samples, no exception
    key = jax.random.PRNGKey(1)
    idx = n(JP._sample_indices(key, jnp.asarray(valid), CFG.pnp.num_hypotheses, CFG.pnp.sample_size))
    rj = JP.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), JC, CFG.pnp, key=key)
    rt = TP.ransac_pnp(t(X), t(uv), t(valid), TC, TCFG.pnp, idx=t(idx))
    assert not bool(rt.ok) and bool(rt.ok) == bool(rj.ok)
    assert int(rt.n_inliers) <= 4


@pytest.mark.parametrize("variant", ["mono", "trim", "stereo"])
def test_motion_only_ba_matches_jax(variant):
    X, uv = _pnp_data()
    valid = np.ones(len(X), bool)
    rj = JP.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), JC, CFG.pnp, key=jax.random.PRNGKey(0))
    T0 = n(rj.T_cw).copy()
    T0[:3, 3] += [0.03, -0.02, 0.05]
    bcfg = BAConfig(trim_px=10.0 if variant == "trim" else 0.0)
    kw_j, kw_t = {}, {}
    if variant == "stereo":
        pc = X @ n(rj.T_cw)[:3, :3].T + n(rj.T_cw)[:3, 3]
        ur = (uv[:, 0] - CFG.camera.bf / pc[:, 2]).astype(np.float32)
        urm = np.arange(len(X)) % 3 != 0
        kw_j = dict(ur=jnp.asarray(ur), ur_mask=jnp.asarray(urm))
        kw_t = dict(ur=t(ur), ur_mask=t(urm))
    bj = JB.motion_only_ba(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), JC, bcfg, **kw_j)
    bt = TB.motion_only_ba(t(T0), t(X), t(uv), t(valid), TC, config_from_jax(VOConfig(ba=bcfg)).ba, **kw_t)
    np.testing.assert_allclose(n(bt.T_cw), n(bj.T_cw), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(bt.inlier_mask), n(bj.inlier_mask))
    np.testing.assert_allclose(float(bt.cost), float(bj.cost), rtol=1e-3)


def test_residuals_and_huber_match_jax():
    X, uv = _pnp_data()
    T = n(JL.se3_exp(jnp.asarray([0.1, 0.0, 0.2, 0.01, 0.02, 0.0], jnp.float32)))
    for a, b in zip(JB.reprojection_residuals(jnp.asarray(T), jnp.asarray(X), jnp.asarray(uv), JC),
                    TB.reprojection_residuals(t(T), t(X), t(uv), TC)):
        np.testing.assert_allclose(n(b), n(a), rtol=1e-5, atol=1e-3)
    r2 = np.linspace(0, 40, 50).astype(np.float32)
    np.testing.assert_allclose(n(TB.huber_weights(t(r2), 2.4)), n(JB.huber_weights(jnp.asarray(r2), 2.4)), rtol=1e-6)
    np.testing.assert_allclose(n(TB._pose_jacobian(t(T), t(X), TC)),
                               n(JB._pose_jacobian(jnp.asarray(T), jnp.asarray(X), JC)), rtol=1e-5, atol=1e-4)
