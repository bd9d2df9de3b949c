"""Multi-view triangulation (batched DLT).

Port of ``stereo_semantic_vo_tpu.ops.triangulation``.  For the
observations (uv_f, T_cw_f) of one landmark, the homogeneous point is the
smallest eigenvector of A'A, A the stacked rows [x_f P_f[2] - P_f[0];
y_f P_f[2] - P_f[1]] of the normalized projection matrices P_f = [R | t],
found by the shifted inverse iteration PnP uses (``ops/pnp.smallest_eigvec``).
Masked views get zero rows.  ``triangulate_batch`` solves every landmark
at once; nothing reads back to the host.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.core.camera import Camera
from stereo_semantic_vo_tpu_torch.core.precision import f32_geometry
from stereo_semantic_vo_tpu_torch.ops.pnp import smallest_eigvec


@f32_geometry
def triangulate_batch(
    T_cw: torch.Tensor,      # (F, 4, 4) camera poses
    uv: torch.Tensor,        # (F, L, 2) pixel observations
    obs_mask: torch.Tensor,  # (F, L) which frames observe each landmark
    cam: Camera,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((L, 3) world points, (L,) bool valid: >= 2 views, a finite
    homogeneous scale and positive depth (> 0.05) in every observing view)."""
    P = T_cw[:, None, :3, :]                                  # (F, 1, 3, 4)
    xn = (uv[..., 0] - cam.cx) / cam.fx                       # (F, L)
    yn = (uv[..., 1] - cam.cy) / cam.fy
    w = obs_mask.to(torch.float32)[..., None]
    rows_u = (xn[..., None] * P[:, :, 2, :] - P[:, :, 0, :]) * w  # (F, L, 4)
    rows_v = (yn[..., None] * P[:, :, 2, :] - P[:, :, 1, :]) * w
    A = torch.cat([rows_u, rows_v], dim=0).transpose(0, 1)    # (L, 2F, 4)
    X_h = smallest_eigvec(A.transpose(1, 2) @ A)              # (L, 4)
    h = X_h[:, 3]
    finite = torch.abs(h) > 1e-9
    X = X_h[:, :3] / torch.where(finite, h, 1e-9)[:, None]
    # cheirality: positive depth in every observing view
    z = torch.einsum("fj,lj->fl", T_cw[:, 2, :3], X) + T_cw[:, None, 2, 3]
    depth_ok = torch.all(torch.where(obs_mask, z > 0.05, True), dim=0)
    valid = (torch.sum(obs_mask, dim=0) >= 2) & depth_ok & finite
    return X, valid


def triangulate(
    T_cw: torch.Tensor,      # (F, 4, 4)
    uv: torch.Tensor,        # (F, 2) observations of one landmark
    obs_mask: torch.Tensor,  # (F,)
    cam: Camera,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((3,) world point, () bool valid): ``triangulate_batch`` of one."""
    X, valid = triangulate_batch(T_cw, uv[:, None], obs_mask[:, None], cam)
    return X[0], valid[0]
