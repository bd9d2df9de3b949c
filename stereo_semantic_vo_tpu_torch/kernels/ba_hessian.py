"""Local bundle-adjustment normal equations: the F poses x L landmarks
block build.

Port of ``stereo_semantic_vo_tpu.kernels.ba_hessian.local_ba_blocks`` with
``ops/local_ba.build_normal_equations``' contract; the kernel is
``csrc/ba_hessian.cu``.  The plain version is the reference's einsum build
over the materialised (F, L, C, 6) / (F, L, C, 3) Jacobians.  The two sum
in different orders, so they agree to float tolerance (rtol 3e-5, atol
1e-4 x max|plain|, cost rtol 1e-5), the tolerance of the reference's own
kernel test.

The motion-only build of the same Pallas module
(``motion_hessian_gradient``, ``BAConfig.hessian_backend="pallas"``) is not
ported (ROADMAP B5).
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.core import lie
from stereo_semantic_vo_tpu_torch.kernels import build
from stereo_semantic_vo_tpu_torch.ops.ba import huber_weights

MAX_FRAMES = 36  # the finalize launch runs one thread per (frame, entry), 28 a frame


def _project(poses, points, cam):
    """-> R (F,3,3), camera points pc (F,L,3), guarded depth z, 1/z, u, v (F,L)."""
    R = poses[:, :3, :3]
    pc = torch.einsum("fij,lj->fli", R, points) + poses[:, None, :3, 3]
    z = torch.where(torch.abs(pc[..., 2]) > 1e-6, pc[..., 2], 1e-6)
    iz = 1.0 / z
    u = cam.fx * pc[..., 0] * iz + cam.cx
    v = cam.fy * pc[..., 1] * iz + cam.cy
    return R, pc, z, iz, u, v


def _residuals(u, v, iz, obs_uv, cam, obs_ur, obs_r_mask):
    rows = [u - obs_uv[..., 0], v - obs_uv[..., 1]]
    if obs_ur is not None:
        rows.append((u - cam.bf * iz - obs_ur) * obs_r_mask.to(torch.float32))
    return torch.stack(rows, dim=-1)  # (F, L, C)


def _robust(r, z, obs_mask, huber_delta):
    """-> IRLS weights (F, L) and the Huber cost ()."""
    w_geom = obs_mask.to(torch.float32) * (z > 0.05)
    r2 = torch.sum(r * r, dim=-1)
    d = huber_delta
    rho = torch.where(r2 <= d * d, r2, 2.0 * d * torch.sqrt(torch.clamp_min(r2, 1e-12)) - d * d)
    return w_geom * huber_weights(r2, huber_delta), torch.sum(w_geom * rho)


def robust_cost(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur=None, obs_r_mask=None):
    """The Huber cost of :func:`residual_and_jacobians` without the Jacobians."""
    _, _, z, iz, u, v = _project(poses, points, cam)
    r = _residuals(u, v, iz, obs_uv, cam, obs_ur, obs_r_mask)
    return _robust(r, z, obs_mask, huber_delta)[1]


def residual_and_jacobians(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur=None, obs_r_mask=None):
    """Residuals and analytic Jacobians for all (frame, landmark) pairs.

    poses (F,4,4), points (L,3), obs_uv (F,L,2), obs_mask (F,L) ->
    r (F,L,C), w (F,L) IRLS weights, Jc (F,L,C,6), Jp (F,L,C,3), cost ().
    With ``obs_ur`` / ``obs_r_mask`` (F,L) a third, stereo residual
    u_R = u - bf/z is added per observation."""
    R, pc, z, iz, u, v = _project(poses, points, cam)
    r = _residuals(u, v, iz, obs_uv, cam, obs_ur, obs_r_mask)
    w, cost = _robust(r, z, obs_mask, huber_delta)
    x, y = pc[..., 0], pc[..., 1]
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zeros = torch.zeros_like(z)
    jrows = [
        torch.stack([fx * iz, zeros, -fx * x * iz2], dim=-1),
        torch.stack([zeros, fy * iz, -fy * y * iz2], dim=-1),
    ]
    if obs_ur is not None:
        # d(u_R)/dpc = d(u)/dpc + bf/z^2 * dz/dpc,  dz/dpc = (0, 0, 1)
        wr = obs_r_mask.to(torch.float32)
        jrows.append(torch.stack([fx * iz, zeros, -fx * x * iz2 + cam.bf * iz2], dim=-1) * wr[..., None])
    duv_dpc = torch.stack(jrows, dim=-2)  # (F, L, C, 3)
    # pose twist [rho, phi], left-multiplied update: dpc/dxi = [I, -hat(pc)]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -lie.hat(pc)], dim=-1)  # (F, L, 3, 6)
    Jc = torch.einsum("flij,fljk->flik", duv_dpc, dpc_dxi)
    Jp = torch.einsum("flij,fjk->flik", duv_dpc, R)
    return r, w, Jc, Jp, cost


def local_ba_blocks_plain(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur=None, obs_r_mask=None):
    """-> (Hcc (F,6,6), Hcp (F,L,6,3), Hpp (L,3,3), gc (F,6), gp (L,3), cost ())."""
    r, w, Jc, Jp, cost = residual_and_jacobians(
        poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur, obs_r_mask
    )
    Jc_w = Jc * w[..., None, None]
    Jp_w = Jp * w[..., None, None]
    Hcc = torch.einsum("flia,flib->fab", Jc_w, Jc)
    Hpp = torch.einsum("flia,flib->lab", Jp_w, Jp)
    Hcp = torch.einsum("flia,flib->flab", Jc_w, Jp)
    gc = torch.einsum("flia,fli->fa", Jc_w, r)
    gp = torch.einsum("flia,fli->la", Jp_w, r)
    return Hcc, Hcp, Hpp, gc, gp, cost


def local_ba_blocks(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur=None, obs_r_mask=None):
    """The block build of :func:`local_ba_blocks_plain`'s contract.  poses
    (F,4,4), points (L,3), obs_uv (F,L,2) float32; obs_mask (F,L) bool;
    ``obs_ur`` (F,L) float32 and ``obs_r_mask`` (F,L) bool add the stereo row.

    A missing ``obs_r_mask`` counts every stereo row, as the reference
    kernel's caller does.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    stereo = obs_ur is not None
    if stereo and obs_r_mask is None:
        obs_r_mask = torch.ones_like(obs_mask)
    if poses.device.type == "cpu":
        return local_ba_blocks_plain(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur, obs_r_mask)
    F, L = obs_mask.shape
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the local-BA kernel takes 1 <= F <= {MAX_FRAMES} poses, got {F}")
    f32 = torch.float32
    intr = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf]).to(f32)
    maskf = obs_mask.to(f32)
    rmf = obs_r_mask.to(f32) if stereo else None
    build.check_cuda(poses, "poses", f32, (F, 4, 4))
    build.check_cuda(points, "points", f32, (L, 3))
    build.check_cuda(obs_uv, "obs_uv", f32, (F, L, 2))
    build.check_cuda(maskf, "obs_mask", f32, (F, L))
    build.check_cuda(intr, "camera", f32, (5,))
    if stereo:
        build.check_cuda(obs_ur, "obs_ur", f32, (F, L))
        build.check_cuda(rmf, "obs_r_mask", f32, (F, L))
    tensors = [poses, points, obs_uv, maskf, intr] + ([obs_ur, rmf] if stereo else [])
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    lib = build.library()
    dev = poses.device
    n_blocks = -(-L // 128)
    Hcc = torch.empty((F, 6, 6), dtype=f32, device=dev)
    Hcp = torch.empty((F, L, 6, 3), dtype=f32, device=dev)
    Hpp = torch.empty((L, 3, 3), dtype=f32, device=dev)
    gc = torch.empty((F, 6), dtype=f32, device=dev)
    gp = torch.empty((L, 3), dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    partial = torch.empty((max(n_blocks, 1), F, 28), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib.call(
            "ssvo_local_ba_blocks",
            poses.data_ptr(), points.data_ptr(), obs_uv.data_ptr(), maskf.data_ptr(),
            obs_ur.data_ptr() if stereo else None, rmf.data_ptr() if stereo else None,
            intr.data_ptr(), F, L, float(huber_delta),
            Hcc.data_ptr(), Hcp.data_ptr(), Hpp.data_ptr(), gc.data_ptr(), gp.data_ptr(),
            cost.data_ptr(), partial.data_ptr(), build.stream_handle(poses),
        )
    local_ba_blocks.launches += 1
    return Hcc, Hcp, Hpp, gc, gp, cost


local_ba_blocks.launches = 0
