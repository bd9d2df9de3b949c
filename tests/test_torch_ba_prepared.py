"""PyTorch port, the BA builds bound once per LM loop (``LocalBABuild`` for
``local_ba``, ``MotionBuild`` for ``motion_only_ba``) against the JAX
package.  On the CPU the bound builds run the plain versions, so these
cases cover the LM loops around them.

Tolerances are the existing ones: a local-BA solve within 5e-3 of JAX's
(the reference's own bound between its two builds) and 0.05 of the truth
where the window constrains every landmark.  With one frame a landmark's
depth rests on one view (mono: on the LM damping alone), and float32
rounding moves it along its ray, so there the points are held within 5e-3
or 1e-3 of their coordinates (~0.05 m at 50 m).  The motion-only pose within
1e-5 of JAX's with equal inlier masks and the cost within rtol 1e-4
(tests/test_torch_motion_hessian.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core import Camera as JCam
from stereo_semantic_vo_tpu.core import CameraConfig as JCamCfg
from stereo_semantic_vo_tpu.core import lie as JLie
from stereo_semantic_vo_tpu.core.config import BAConfig as JBA
from stereo_semantic_vo_tpu.ops import ba as JB
from stereo_semantic_vo_tpu.ops import local_ba as JL
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.core.config import BAConfig as TBA
from stereo_semantic_vo_tpu_torch.core.config import CameraConfig as TCamCfg
from stereo_semantic_vo_tpu_torch.kernels import ba_hessian as TK
from stereo_semantic_vo_tpu_torch.ops import ba as TB
from stereo_semantic_vo_tpu_torch.ops import local_ba as TL
from tests.test_ba_hessian import _problem as motion_problem
from tests.test_torch_local_ba import _problem as window_problem
from tests.torch_parity import n, t

JC, TC = JCam.from_config(JCamCfg()), TCam.from_config(TCamCfg(), "cpu")


@pytest.mark.parametrize("F", [1, 4, 8])
@pytest.mark.parametrize("stereo", [False, True])
def test_local_ba_on_the_bound_build_matches_jax(F, stereo):
    poses, X, obs, mask, ur, rm = window_problem(seed=20 + F, F=F, L=256, noise=0.0, stereo=stereo, p_obs=1.0)
    X0 = (X + np.random.RandomState(F).normal(0, 0.15, X.shape)).astype(np.float32)
    jcfg = dataclasses.replace(JBA(), local_iterations=5)
    L = X.shape[0]
    jopt = dict(obs_ur=jnp.asarray(ur), obs_r_mask=jnp.asarray(rm)) if stereo else {}
    topt = dict(obs_ur=t(ur), obs_r_mask=t(rm)) if stereo else {}
    want = JL.local_ba(*(jnp.asarray(a) for a in (poses, X0, obs, mask)), jnp.ones(L, bool), JC, jcfg, **jopt)
    args = (*(t(a) for a in (poses, X0, obs, mask)), torch.ones(L, dtype=torch.bool), TC)
    res, plain = (TL.local_ba(*args, TBA(**{**dataclasses.asdict(jcfg), "local_hessian_backend": b}), **topt)
                  for b in ("pallas", "xla"))
    np.testing.assert_allclose(n(res.points), n(want.points), atol=5e-3, rtol=1e-3 if F == 1 else 0.0)
    np.testing.assert_allclose(n(res.poses), n(want.poses), atol=5e-3)
    np.testing.assert_allclose(float(res.cost), float(want.cost), rtol=1e-2, atol=1e-2)
    if F > 1:  # two views or more fix every landmark
        assert np.abs(n(res.points) - X).max() < 0.05
    # on the CPU the bound build is the plain one: the two loops agree exactly
    for a, b in zip(res, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [300, 517])
@pytest.mark.parametrize("trim_px", [0.0, 10.0])
def test_motion_only_ba_on_the_bound_build_matches_jax(K, trim_px):
    X, uv, mask, T_true = (n(a) for a in motion_problem(seed=K, K=K))
    T0 = (n(JLie.se3_exp(jnp.asarray([0.06, -0.02, -0.05, 0.005, -0.002, 0.003], jnp.float32))) @ T_true)
    T0 = T0.astype(np.float32)
    jcfg = dataclasses.replace(JBA(), hessian_backend="pallas", trim_px=trim_px)
    bj = JB.motion_only_ba(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask), JC, jcfg)
    before = TK.motion_hessian_gradient.launches
    bt = TB.motion_only_ba(t(T0), t(X), t(uv), t(mask), TC, TBA(**dataclasses.asdict(jcfg)))
    assert TK.motion_hessian_gradient.launches == before  # a CPU tensor launches nothing
    np.testing.assert_allclose(n(bt.T_cw), n(bj.T_cw), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(bt.inlier_mask), n(bj.inlier_mask))
    np.testing.assert_allclose(float(bt.cost), float(bj.cost), rtol=1e-4)
    np.testing.assert_allclose(n(bt.T_cw), T_true, atol=5e-3)


def test_local_intrinsics_equals_the_stack_it_replaces():
    cam = TCam.from_config(dataclasses.replace(TCamCfg(), fx=701.5, cy=180.25, bf=390.0), "cpu")
    got = TK.local_intrinsics(cam)
    assert got.dtype == torch.float32 and got.shape == (5,)
    assert torch.equal(got, torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf]).to(torch.float32))
    assert torch.equal(got[:4], TK.motion_intrinsics(cam))


def test_bound_local_build_on_cpu_equals_the_one_shot_build():
    poses, X, obs, mask, ur, rm = window_problem(seed=3, F=4, L=64, stereo=True)
    before = TK.local_ba_blocks.launches
    bound = TK.LocalBABuild(t(obs), t(mask), TC, 2.0, t(ur), t(rm))
    for step in range(2):
        pts = t(X + 0.01 * step)
        got = bound(t(poses), pts)
        want = TK.local_ba_blocks(t(poses), pts, t(obs), t(mask), TC, 2.0, t(ur), t(rm))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert TK.local_ba_blocks.launches == before


def test_bound_motion_build_on_cpu_equals_the_one_shot_build():
    X, uv, mask, T_true = (n(a) for a in motion_problem(seed=2, K=128))
    args = (t(np.ascontiguousarray(X.T)), t(np.ascontiguousarray(uv.T)), t(mask.astype(np.float32)[None]),
            TK.motion_intrinsics(TC), 2.0)
    before = TK.motion_hessian_gradient.launches
    bound = TK.MotionBuild(*args)
    for T in (T_true, T_true @ n(JLie.se3_exp(jnp.asarray([0.01, 0, 0, 0, 0.002, 0], jnp.float32)))):
        for a, b in zip(bound(t(T)), TK.motion_hessian_gradient(t(T), *args)):
            assert torch.equal(a, b)
    assert TK.motion_hessian_gradient.launches == before
