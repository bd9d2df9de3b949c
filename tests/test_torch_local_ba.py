"""PyTorch port, local bundle adjustment (normal equations, Schur solve, LM)
and the plain version of kernel 7 (the local-BA block build) against the
JAX package.

The JAX side builds with its einsum ("xla") path and with
``local_ba_blocks`` in interpret mode.  Tolerances: the blocks rtol 3e-5,
atol 1e-4 x max|reference|, cost rtol 1e-5 (tests/test_ba_hessian.py's
bounds, float32 sums in another order); Schur steps atol 1e-3 x max|step|;
a converged LM solve within 5e-3 of JAX's (the reference's own bound
between its two builds) and 0.05 of the truth."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core.camera import Camera as JCam
from stereo_semantic_vo_tpu.core.config import BAConfig, CameraConfig
from stereo_semantic_vo_tpu.kernels.ba_hessian import local_ba_blocks as j_blocks
from stereo_semantic_vo_tpu.ops import local_ba as JL
from stereo_semantic_vo_tpu_torch.core import lie as TLie
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.core.config import BAConfig as TBA
from stereo_semantic_vo_tpu_torch.core.config import CameraConfig as TCC
from stereo_semantic_vo_tpu_torch.kernels import ba_hessian as TK
from stereo_semantic_vo_tpu_torch.ops import local_ba as TL
from tests.torch_parity import n, t

JCAM, TCAM = JCam.from_config(CameraConfig()), TCam.from_config(TCC(), "cpu")
DELTA = float(BAConfig().huber_delta)
NAMES = ("Hcc", "Hcp", "Hpp", "gc", "gp")


def _problem(seed=1, F=4, L=512, noise=1.5, stereo=False, p_obs=0.8):
    """Poses along x (and z), landmarks 8-50 m ahead, noisy pixel (and
    right-image u) observations, a share ``p_obs`` observed (and ~70% of
    those with stereo)."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)], -1).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    for f in range(F):
        poses[f][0, 3] = -0.8 * f
        poses[f][2, 3] = 0.3 * f
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    c = CameraConfig()
    u = c.fx * pc[..., 0] / pc[..., 2] + c.cx
    v = c.fy * pc[..., 1] / pc[..., 2] + c.cy
    obs = (np.stack([u, v], -1) + rng.normal(0, noise, (F, L, 2))).astype(np.float32)
    mask = (pc[..., 2] > 0.5) & (rng.rand(F, L) < p_obs)
    ur = rm = None
    if stereo:
        ur = (u - c.bf / pc[..., 2] + rng.normal(0, 0.8 * noise, u.shape)).astype(np.float32)
        rm = mask & (rng.rand(F, L) > 0.3)
    return poses, X, obs, mask, ur, rm


def _assert_blocks(got, want):
    for name, a, b in zip(NAMES, got, want):
        b = n(b)
        np.testing.assert_allclose(n(a), b, rtol=3e-5, atol=1e-4 * max(float(np.abs(b).max()), 1.0), err_msg=name)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-5)


CASES = [(4, False), (4, True), (8, False), (8, True)]


@pytest.mark.parametrize("F,stereo", CASES)
def test_plain_build_matches_jax_xla(F, stereo):
    poses, X, obs, mask, ur, rm = _problem(seed=F + stereo, F=F, stereo=stereo)
    jopt = dict(obs_ur=jnp.asarray(ur), obs_r_mask=jnp.asarray(rm)) if stereo else {}
    topt = dict(obs_ur=t(ur), obs_r_mask=t(rm)) if stereo else {}
    want = JL.build_normal_equations(*(jnp.asarray(a) for a in (poses, X, obs, mask)), JCAM, DELTA, **jopt)
    got = TL.build_normal_equations(*(t(a) for a in (poses, X, obs, mask)), TCAM, DELTA, **topt)
    _assert_blocks(got, want)


@pytest.mark.parametrize("F,stereo", [(4, False), (8, True)])
def test_kernel_wrapper_matches_jax_pallas_interpret(F, stereo):
    """The kernel's contract against the TPU kernel; on a CPU tensor the
    wrapper runs the plain version."""
    poses, X, obs, mask, ur, rm = _problem(seed=10 + F + stereo, F=F, stereo=stereo)
    urmT = jnp.stack([jnp.asarray(ur), jnp.asarray(rm, jnp.float32)], axis=1) if stereo else None
    want = j_blocks(jnp.asarray(poses), jnp.asarray(X).T, jnp.swapaxes(jnp.asarray(obs), 1, 2),
                    jnp.asarray(mask, jnp.float32), JCAM, DELTA, urmT=urmT)
    opt = (t(ur), t(rm)) if stereo else ()
    got = TK.local_ba_blocks(*(t(a) for a in (poses, X, obs, mask)), TCAM, DELTA, *opt)
    _assert_blocks(got, want)
    if stereo:  # the "pallas" dispatch fills a missing stereo mask with ones, as the reference does
        a = TL.build_normal_equations(*(t(a) for a in (poses, X, obs, mask)), TCAM, DELTA,
                                      backend="pallas", obs_ur=t(ur))
        b = TL.build_normal_equations(*(t(a) for a in (poses, X, obs, mask)), TCAM, DELTA,
                                      obs_ur=t(ur), obs_r_mask=torch.ones(mask.shape, dtype=torch.bool))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_schur_solve_matches_jax():
    poses, X, obs, mask, ur, rm = _problem(seed=2, stereo=True)
    pv = np.ones(X.shape[0], bool)
    pv[:7] = False
    jeq = JL.build_normal_equations(*(jnp.asarray(a) for a in (poses, X, obs, mask)), JCAM, DELTA,
                                    obs_ur=jnp.asarray(ur), obs_r_mask=jnp.asarray(rm))
    teq = TL.NormalEq(*(t(n(a)) for a in jeq))  # the same blocks into both solvers
    for fix in (True, False):
        want = JL.schur_solve(jeq, jnp.float32(1e-3), jnp.asarray(pv), fix_first_pose=fix)
        got = TL.schur_solve(teq, torch.tensor(1e-3), t(pv), fix_first_pose=fix)
        for a, b in zip(got, want):
            b = n(b)
            np.testing.assert_allclose(n(a), b, rtol=0, atol=1e-3 * float(np.abs(b).max()))
        np.testing.assert_array_equal(n(got[1])[:7], 0.0)  # invalid landmarks get no step


def test_schur_equals_dense_solve():
    """The Schur reduction reproduces the full dense normal-equation solve."""
    F, L = 3, 30
    poses, X, obs, mask, _, _ = _problem(seed=4, F=F, L=L, noise=0.5)
    lam = torch.tensor(1e-3)
    eq = TL.build_normal_equations(*(t(a) for a in (poses, X, obs, mask)), TCAM, DELTA)
    dx_c, dx_p = TL.schur_solve(eq, lam, torch.ones(L, dtype=torch.bool))
    size = F * 6 + L * 3
    H, g = np.zeros((size, size)), np.zeros(size)
    Hcc, Hpp, Hcp = n(TL._damp(eq.Hcc, lam)), n(TL._damp(eq.Hpp, lam)), n(eq.Hcp)
    for f in range(F):
        H[6 * f : 6 * f + 6, 6 * f : 6 * f + 6] = Hcc[f]
        g[6 * f : 6 * f + 6] = n(eq.gc[f])
    for l in range(L):
        o = F * 6 + 3 * l
        H[o : o + 3, o : o + 3] = Hpp[l]
        g[o : o + 3] = n(eq.gp[l])
        for f in range(F):
            H[6 * f : 6 * f + 6, o : o + 3] = Hcp[f, l]
            H[o : o + 3, 6 * f : 6 * f + 6] = Hcp[f, l].T
    H[:6, :6] += np.eye(6) * TL._GAUGE_PRIOR
    dx = -np.linalg.solve(H, g)
    # float32 normal equations (fx^2 ~ 5e5 entries): the reference test's bounds
    np.testing.assert_allclose(n(dx_c), dx[: F * 6].reshape(F, 6), atol=1e-4)
    np.testing.assert_allclose(n(dx_p), dx[F * 6 :].reshape(L, 3), atol=2e-3)


@pytest.mark.parametrize("stereo", [False, True])
def test_local_ba_converges_and_matches_jax(stereo):
    poses, X, obs, mask, ur, rm = _problem(seed=7, noise=0.0, stereo=stereo, p_obs=1.0)
    X0 = (X + np.random.RandomState(8).normal(0, 0.15, X.shape)).astype(np.float32)
    cfg = dataclasses.replace(BAConfig(), local_iterations=8)
    L = X.shape[0]
    jopt = dict(obs_ur=jnp.asarray(ur), obs_r_mask=jnp.asarray(rm)) if stereo else {}
    topt = dict(obs_ur=t(ur), obs_r_mask=t(rm)) if stereo else {}
    want = JL.local_ba(*(jnp.asarray(a) for a in (poses, X0, obs, mask)), jnp.ones(L, bool), JCAM, cfg, **jopt)
    got = TL.local_ba(*(t(a) for a in (poses, X0, obs, mask)), torch.ones(L, dtype=torch.bool), TCAM,
                      TBA(**dataclasses.asdict(cfg)), **topt)
    assert np.abs(n(got.points) - X).max() < 0.05
    np.testing.assert_allclose(n(got.points), n(want.points), atol=5e-3)
    np.testing.assert_allclose(n(got.poses), n(want.poses), atol=5e-3)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-2, atol=1e-2)


def test_local_ba_fixes_gauge_and_leaves_invalid_points():
    poses, X, obs, mask, _, _ = _problem(seed=9, noise=0.0, p_obs=1.0)
    L = X.shape[0]
    X0 = (X + 0.1).astype(np.float32)
    pv = np.arange(L) < L // 2
    res = TL.local_ba(*(t(a) for a in (poses, X0, obs, mask)), t(pv), TCAM, TBA(local_iterations=3))
    np.testing.assert_array_equal(n(res.points)[~pv], X0[~pv])
    dT = n(res.poses[0] @ TLie.T_inv(t(poses[0])))
    assert np.linalg.norm(dT[:3, 3]) < 1e-4
