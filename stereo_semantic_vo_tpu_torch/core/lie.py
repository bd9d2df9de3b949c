"""SO(3)/SE(3) Lie-group operations on batched tensors.

Port of ``stereo_semantic_vo_tpu.core.lie``.  Poses are 4x4 row-major
world->camera transforms ``Tcw``; twists are (6,) ``[rho, phi]`` =
[translation, rotation].  Every branch is a ``torch.where``, so nothing here
reads a value back to the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(Phi: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], dim=-1)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3), Taylor-guarded at 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    K = hat(phi)
    KK = K @ K
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye_like(K) + a * K + b * KK


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, guarded near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.sin(theta)
    small = theta[..., None] < 1e-6
    scale = torch.where(
        small,
        1.0 + theta[..., None] ** 2 / 6.0,
        theta[..., None] / torch.clamp_min(sin_theta[..., None], _EPS),
    )
    near_pi = theta[..., None] > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp_min(
        (diag - cos_theta[..., None]) / torch.clamp_min(1.0 - cos_theta[..., None], _EPS), 0.0
    )
    axis = torch.sqrt(axis_sq) * torch.where(w >= 0, 1.0, -1.0)
    return torch.where(near_pi, axis * theta[..., None], w * scale)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    K = hat(phi)
    KK = K @ K
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    return _eye_like(K) + a * K + b * KK


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: (..., 6) twist [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return rt_to_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = torch.linalg.solve_ex(_so3_left_jacobian(phi), T[..., :3, 3:4])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)  # a device fill; `= 1.0` copies a host scalar and syncs
    return torch.cat([top, bottom], dim=-2)


def T_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(3, 3) -> (4,) quaternion [qx, qy, qz, qw] (Shepperd's method; all
    four branches are evaluated and one is selected)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return _sqrt_rn(torch.clamp_min(x, _EPS)) * 2.0

    s = root(tr + 1.0)
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s])
    s = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s])
    s = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s])
    s = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s])

    branch = torch.where(tr > 0.0, 0, torch.argmax(torch.stack([m00, m11, m22])) + 1)
    q = torch.stack([qw, qx, qy, qz]).index_select(0, branch.reshape(1))[0]
    # the norm as the reference's XLA CPU build reduces it: a fused
    # multiply-add a term, in order (a float32 square is exact in float64, so
    # each step rounds once); vector_norm's order differs in the last bit
    # for ~1 rotation in 8, and so does the TUM file's 7th decimal
    acc = torch.zeros((), dtype=torch.float64, device=q.device)
    for v in q.double():
        acc = (acc + v * v).float().double()
    return q / _sqrt_rn(acc.float())


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest, as XLA's is: through float64,
    whose root rounds to float32 correctly.  torch's float32 ``sqrt`` on the
    CPU may round a near-tie the other way."""
    return torch.sqrt(x.double()).float()


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(4,) [qx, qy, qz, qw] -> (3, 3)."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > _EPS, 2.0 / n, 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy]),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx]),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)]),
        ]
    )
