"""Motion-only bundle adjustment as Levenberg-Marquardt on tensors:
masked reprojection residuals, Huber IRLS weights, the analytic 2x6 pose
Jacobian, an optional stereo u_R row, and a fixed number of LM steps whose
accept/reject decisions are ``torch.where`` selections.  The normal
equations are the einsum over the (K, 2, 6) Jacobian (the port's fused
build, ``hessian_backend="pallas"``, computes the same sums).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference import lie
from vo_bench.reference.camera import Camera
from vo_bench.reference.config import BAConfig
from vo_bench.reference.plain import huber_weights
from vo_bench.reference.precision import f32_geometry


class BAResult(NamedTuple):
    T_cw: torch.Tensor         # (4, 4) optimized world->camera pose
    cost: torch.Tensor         # () final robust cost
    inlier_mask: torch.Tensor  # (K,) chi2 <= 4 * 5.991 at the final pose
    n_iters: torch.Tensor      # () iterations accepted


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) > 1e-6, z, 1e-6)


def reprojection_residuals(
    T_cw: torch.Tensor, X_w: torch.Tensor, uv: torch.Tensor, cam: Camera
) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, 2) pixel residuals and (K,) camera-frame depths."""
    pc = lie.transform_points(T_cw, X_w)
    z = pc[..., 2]
    safe_z = _safe_z(z)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    return torch.stack([u, v], dim=-1) - uv, z


def _pose_jacobian(T_cw: torch.Tensor, X_w: torch.Tensor, cam: Camera) -> torch.Tensor:
    """d(residual)/d(twist) for the left update T <- exp(xi) T: (K, 2, 6)."""
    pc = lie.transform_points(T_cw, X_w)
    x, y = pc[..., 0], pc[..., 1]
    iz = 1.0 / _safe_z(pc[..., 2])
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(x)
    du = torch.stack(
        [fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2, fx * (1.0 + x * x * iz2), -fx * y * iz],
        dim=-1,
    )
    dv = torch.stack(
        [zero, fy * iz, -fy * y * iz2, -fy * (1.0 + y * y * iz2), fy * x * y * iz2, fy * x * iz],
        dim=-1,
    )
    return torch.stack([du, dv], dim=-2)


@f32_geometry
def motion_only_ba(
    T0_cw: torch.Tensor,
    X_w: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    cam: Camera,
    cfg: BAConfig,
    use_huber: bool = True,
    ur: torch.Tensor | None = None,
    ur_mask: torch.Tensor | None = None,
) -> BAResult:
    """Pose-only LM over masked reprojection residuals.

    T0_cw: (4, 4) initial pose; X_w: (K, 3); uv: (K, 2); mask: (K,) bool.
    ``ur``/``ur_mask`` (K,) add the stereo residual row u_R = u - bf/z.
    With ``cfg.trim_px > 0`` observations farther than trim_px from the seed
    pose's projection are left out of the optimization (classified once)."""
    stereo = ur is not None
    chi2_th = cfg.huber_delta**2
    m = mask.to(torch.float32)
    if use_huber and cfg.trim_px > 0.0:
        r0, z0 = reprojection_residuals(T0_cw, X_w, uv, cam)
        close0 = torch.sum(r0 * r0, dim=-1) <= cfg.trim_px**2
        m = m * close0 * (z0 > 0.05)
    if stereo:
        urm = ur_mask.to(torch.float32) if ur_mask is not None else torch.ones_like(ur)
    def stereo_residual(T):
        pc = lie.transform_points(T, X_w)
        z = _safe_z(pc[..., 2])
        u_pred = cam.fx * pc[..., 0] / z + cam.cx
        return (u_pred - cam.bf / z - ur) * urm

    def robust_cost(T):
        r, z = reprojection_residuals(T, X_w, uv, cam)
        w_geom = m * (z > 0.05)
        r2 = torch.sum(r * r, dim=-1)
        if stereo:
            rs = stereo_residual(T)
            r2 = r2 + rs * rs
        if use_huber:
            d = cfg.huber_delta
            rho = torch.where(
                r2 <= d * d, r2, 2.0 * d * torch.sqrt(torch.clamp_min(r2, 1e-12)) - d * d
            )
        else:
            rho = r2
        return torch.sum(w_geom * rho), r, w_geom, r2

    T = T0_cw
    lam = torch.full((), cfg.init_lambda, dtype=torch.float32, device=X_w.device)
    cost = robust_cost(T)[0]
    n_accept = torch.zeros((), dtype=torch.int64, device=X_w.device)
    for _ in range(cfg.iterations):
        _, r, w_geom, r2 = robust_cost(T)
        w = w_geom * huber_weights(r2, cfg.huber_delta) if use_huber else w_geom
        J = _pose_jacobian(T, X_w, cam)                  # (K, 2, 6)
        Jw = J * w[:, None, None]
        H = torch.einsum("kif,kig->fg", Jw, J)
        g = torch.einsum("kif,ki->f", Jw, r)
        if stereo:
            # d(u_R)/dxi = d(u)/dxi + bf/z^2 * dz/dxi, dz/dxi = [0,0,1,y,-x,0]
            pc = lie.transform_points(T, X_w)
            x_, y_ = pc[..., 0], pc[..., 1]
            z_ = _safe_z(pc[..., 2])
            b2 = cam.bf / (z_ * z_)
            zero, one = torch.zeros_like(z_), torch.ones_like(z_)
            dz = torch.stack([zero, zero, one, y_, -x_, zero], dim=-1)
            Js = (J[:, 0, :] + b2[:, None] * dz) * urm[:, None]
            rs = stereo_residual(T)
            H = H + torch.einsum("kf,kg->fg", Js * w[:, None], Js)
            g = g + torch.einsum("kf,k->f", Js * w[:, None], rs)
        Hl = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        sol, info = torch.linalg.solve_ex(Hl, g)
        delta = torch.where(info == 0, -sol, torch.nan)   # singular: reject the step
        T_new = lie.se3_exp(delta) @ T
        new_cost = robust_cost(T_new)[0]
        accept = new_cost < cost
        T = torch.where(accept, T_new, T)
        lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
        n_accept = n_accept + accept
    r, z = reprojection_residuals(T, X_w, uv, cam)
    r2 = torch.sum(r * r, dim=-1)
    inliers = mask & (z > 0.05) & (r2 <= chi2_th * 4.0)
    return BAResult(T_cw=T, cost=cost, inlier_mask=inliers, n_iters=n_accept)
