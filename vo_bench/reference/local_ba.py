"""Local bundle adjustment: sliding-window poses and landmarks, solved by
Levenberg-Marquardt with Schur-complement elimination of the landmark block.
The normal equations are dense batched blocks

  H = [ Hcc  Hcp ]   Hcc: (F, 6, 6) block-diagonal pose blocks
      [ Hcp' Hpp ]   Hpp: (L, 3, 3) block-diagonal landmark blocks
                     Hcp: (F, L, 6, 3) coupling blocks

built from the materialised Jacobians (the port's block-build kernel sums
the same terms in another order), and the landmark block is eliminated in
closed form.  Gauge freedom is fixed by a strong prior on pose 0.  Every
accept/reject is a ``torch.where`` and the inverses are ``inv_ex`` /
``solve_ex``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference import lie
from vo_bench.reference.camera import Camera
from vo_bench.reference.config import BAConfig
from vo_bench.reference.precision import f32_geometry
from vo_bench.reference.plain import local_ba_blocks_plain, robust_cost

_GAUGE_PRIOR = 1e8


class LocalBAResult(NamedTuple):
    poses: torch.Tensor   # (F, 4, 4)
    points: torch.Tensor  # (L, 3)
    cost: torch.Tensor


class NormalEq(NamedTuple):
    Hcc: torch.Tensor  # (F, 6, 6)
    Hcp: torch.Tensor  # (F, L, 6, 3)
    Hpp: torch.Tensor  # (L, 3, 3)
    gc: torch.Tensor   # (F, 6)
    gp: torch.Tensor   # (L, 3)
    cost: torch.Tensor


def build_normal_equations(poses, points, obs_uv, obs_mask, cam: Camera, huber_delta: float,
                           obs_ur=None, obs_r_mask=None) -> NormalEq:
    return NormalEq(*local_ba_blocks_plain(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur, obs_r_mask))


def _damp(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Multiplicative LM damping on the block diagonal: H + lam*diag(H)."""
    n = H.shape[-1]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + lam * torch.eye(n, dtype=H.dtype, device=H.device) * (diag[..., None, :] + 1e-6)


@f32_geometry
def schur_solve(
    eq: NormalEq, lam: torch.Tensor, point_valid: torch.Tensor, fix_first_pose: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced-camera-system solve.  Returns (dx_c (F, 6), dx_p (L, 3)); a
    singular system gives NaN steps, which the LM loop rejects."""
    F = eq.Hcc.shape[0]
    pv = point_valid.to(torch.float32)
    eye3 = torch.eye(3, dtype=eq.Hpp.dtype, device=eq.Hpp.device)

    # damped, validity-masked landmark blocks (invalid -> identity, zero rhs)
    Hpp_d = torch.where(pv[:, None, None] > 0, _damp(eq.Hpp, lam), eye3)
    Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0] * pv[:, None, None]

    # S = Hcc + damping - sum_l Hcp Hpp^-1 Hcp'
    Wt = torch.einsum("flab,lbc->flac", eq.Hcp, Hpp_inv)       # (F, L, 6, 3)
    S_blocks = torch.einsum("flac,glbc->fgab", Wt, eq.Hcp)     # (F, F, 6, 6)
    rhs_blocks = torch.einsum("flac,lc->fa", Wt, eq.gp)        # (F, 6)
    Hcc, gc = eq.Hcc, eq.gc
    on_diag = torch.eye(F, dtype=torch.bool, device=eq.Hcc.device)[:, :, None, None]
    S = torch.where(on_diag, _damp(Hcc, lam)[:, None] - S_blocks, -S_blocks)
    rhs = gc - rhs_blocks

    S_flat = S.transpose(1, 2).reshape(F * 6, F * 6)
    if fix_first_pose:
        prior = torch.zeros(F * 6, dtype=S.dtype, device=S.device)
        prior[:6].fill_(_GAUGE_PRIOR)  # a device fill: `= value` would copy from the host
        S_flat = S_flat + torch.diag(prior)
    sol, info = torch.linalg.solve_ex(S_flat, rhs.reshape(F * 6))
    dx_c = torch.where(info == 0, -sol, torch.nan).reshape(F, 6)

    # back-substitute landmarks: dx_p = -Hpp^-1 (gp + Hcp' dx_c)
    gp_eff = eq.gp + torch.einsum("flab,fa->lb", eq.Hcp, dx_c)
    dx_p = -torch.einsum("lab,lb->la", Hpp_inv, gp_eff)
    return dx_c, dx_p


@f32_geometry
def local_ba(
    poses: torch.Tensor,
    points: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_mask: torch.Tensor,
    point_valid: torch.Tensor,
    cam: Camera,
    cfg: BAConfig,
    fix_first_pose: bool = True,
    obs_ur: torch.Tensor | None = None,
    obs_r_mask: torch.Tensor | None = None,
) -> LocalBAResult:
    """``cfg.local_iterations`` LM steps over Schur-complement solves.
    poses (F,4,4), points (L,3), obs_uv (F,L,2), obs_mask (F,L),
    point_valid (L,); ``obs_ur`` / ``obs_r_mask`` (F,L) add stereo edges."""
    obs_mask = obs_mask & point_valid[None, :]

    def total_cost(po, pt):
        return robust_cost(po, pt, obs_uv, obs_mask, cam, cfg.huber_delta, obs_ur, obs_r_mask)

    po, pt = poses, points
    lam = torch.full((), cfg.init_lambda, dtype=torch.float32, device=poses.device)
    cost = total_cost(po, pt)
    for _ in range(cfg.local_iterations):
        eq = build_normal_equations(po, pt, obs_uv, obs_mask, cam, cfg.huber_delta, obs_ur, obs_r_mask)
        dx_c, dx_p = schur_solve(eq, lam, point_valid, fix_first_pose)
        po_new = lie.se3_exp(dx_c) @ po
        pt_new = pt + dx_p
        new_cost = total_cost(po_new, pt_new)
        accept = new_cost < cost
        po = torch.where(accept, po_new, po)
        pt = torch.where(accept, pt_new, pt)
        lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return LocalBAResult(poses=po, points=pt, cost=cost)
