"""Bundle-adjustment normal-equation builds: the motion-only build and the
F poses x L landmarks local-BA block build.

Ports of ``stereo_semantic_vo_tpu.kernels.ba_hessian``; both kernels are in
``csrc/ba_hessian.cu``.

* ``motion_hessian_gradient`` (``BAConfig.hessian_backend="pallas"``): the
  6x6 Hessian, gradient and Huber cost of mono motion-only BA, in the
  reference's transposed layout (Xt (3, K), uvt (2, K), maskf (1, K)),
  with the intrinsics as one (4,) tensor (``motion_intrinsics``).
  The plain version builds the 21 unique H entries, the 6 g entries and
  the cost from the per-observation terms as the Pallas body does.
* ``local_ba_blocks``, with ``ops/local_ba.build_normal_equations``'
  contract.  The plain version is the reference's einsum build over the
  materialised (F, L, C, 6) / (F, L, C, 3) Jacobians.

Both sit in LM loops that pass the same observations every step.
``MotionBuild`` and ``LocalBABuild`` check and bind those once per loop, so
that a step checks only the pose (and points), allocates at most one
output buffer and makes one ctypes call: one launch, nothing staged.  The
public functions are one-shot uses of them.

Kernel and plain version sum in different orders, so they agree to float
tolerance, the reference's own kernel test's (tests/test_ba_hessian.py):
the motion build within rtol 2e-5 and atol 1e-6 x max|plain|, the local
blocks within rtol 3e-5 and atol 1e-4 x max|plain|, the cost within rtol
1e-5 for both.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_semantic_vo_tpu_torch.core import lie
from stereo_semantic_vo_tpu_torch.kernels import build
from stereo_semantic_vo_tpu_torch.ops.ba import huber_weights

LOCAL_BA_TILE = 64  # landmarks a block of the local-BA kernel takes (csrc/ba_hessian.cu)


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


def motion_intrinsics(cam) -> torch.Tensor:
    """[fx, fy, cx, cy] as one (4,) float32 tensor on the camera's device:
    a device stack, no readback.  Made once per ``motion_only_ba`` call."""
    return torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]).to(torch.float32)


def local_intrinsics(cam) -> torch.Tensor:
    """[fx, fy, cx, cy, bf] as one (5,) float32 tensor on the camera's
    device, for the local-BA kernel.  Made once per ``local_ba`` call."""
    return torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf]).to(torch.float32)


def _check_step(t, name: str, shape: tuple, index: int) -> None:
    """A step's moving operand: cheap attribute reads only."""
    if not (t.is_cuda and t.dtype is torch.float32 and t.shape == shape and t.is_contiguous()
            and t.get_device() == index):
        raise ValueError(f"{name}: expected a contiguous float32 {shape} tensor on cuda:{index}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launcher(name: str, index: int):
    """-> launch(*args): the C entry point ``name``, called on device
    ``index``: under a device guard only where another device is current,
    which each call checks with one integer comparison."""
    fn = build.library().function(name)

    def launch(*args):
        if torch.cuda.current_device() == index:
            rc = fn(*args)
        else:
            with torch.cuda.device(index):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")

    return launch


def motion_hessian_gradient_plain(T_cw, Xt, uvt, maskf, intr, delta):
    """-> (H (6,6), g (6,), cost ()) of the Pallas body's arithmetic."""
    fx, fy, cx, cy = intr.unbind()
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    xw, yw, zw = Xt[0], Xt[1], Xt[2]
    px = R[0, 0] * xw + R[0, 1] * yw + R[0, 2] * zw + t[0]
    py = R[1, 0] * xw + R[1, 1] * yw + R[1, 2] * zw + t[1]
    pz = R[2, 0] * xw + R[2, 1] * yw + R[2, 2] * zw + t[2]
    iz = 1.0 / torch.where(torch.abs(pz) > 1e-6, pz, 1e-6)
    iz2 = iz * iz
    ru = fx * px * iz + cx - uvt[0]
    rv = fy * py * iz + cy - uvt[1]
    mask_pos = maskf[0] * (pz > 0.05)
    r2 = ru * ru + rv * rv
    r = torch.sqrt(torch.clamp_min(r2, 1e-12))
    w = mask_pos * torch.where(r <= delta, 1.0, delta / r)
    rho = mask_pos * torch.where(r2 <= delta * delta, r2, 2.0 * delta * r - delta * delta)
    zero = torch.zeros_like(pz)
    Ju = torch.stack([fx * iz, zero, -fx * px * iz2, -fx * px * py * iz2, fx * (1.0 + px * px * iz2), -fx * py * iz])
    Jv = torch.stack([zero, fy * iz, -fy * py * iz2, -fy * (1.0 + py * py * iz2), fy * px * py * iz2, fy * px * iz])
    a, b = torch.triu_indices(6, 6, device=T_cw.device)  # the 21 unique entries, row-major
    h = torch.sum(w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]), dim=-1)
    H = torch.zeros((6, 6), dtype=torch.float32, device=T_cw.device)
    H = H.index_put((a, b), h).index_put((b, a), h)
    g = torch.sum(w * (Ju * ru + Jv * rv), dim=-1)
    return H, g, torch.sum(rho)


class MotionBuild:
    """B5 bound to one ``motion_only_ba`` call: ``Xt`` (3,K), ``uvt`` (2,K),
    ``maskf`` (1,K) float32 {0, 1} and ``intr`` (``motion_intrinsics``)
    are checked once and kept by pointer; ``build(T_cw)`` -> (H (6,6),
    g (6,), cost ()) for a (4,4) pose.

    On the card every call launches the kernel once into the same 43-float
    buffer and returns the same views of it, so a step's results are valid
    until the next call is enqueued.  CPU tensors take the plain version."""

    def __init__(self, Xt, uvt, maskf, intr, delta: float):
        self._plain = Xt.device.type == "cpu"
        if self._plain:
            self._args = (Xt, uvt, maskf, intr, delta)
            return
        f32 = torch.float32
        K = Xt.shape[-1]
        build.check_cuda(Xt, "Xt", f32, (3, K))
        build.check_cuda(uvt, "uvt", f32, (2, K))
        build.check_cuda(maskf, "maskf", f32, (1, K))
        build.check_cuda(intr, "intr", f32, (4,))
        self._index = Xt.get_device()
        if any(x.get_device() != self._index for x in (uvt, maskf, intr)):
            raise ValueError("all tensors must be on one device")
        self._launch = _launcher("ssvo_motion_hessian_gradient", self._index)
        self._out = torch.empty(43, dtype=f32, device=Xt.device)
        self._views = (self._out[:36].view(6, 6), self._out[36:42], self._out[42])
        self._keep = (Xt, uvt, maskf, intr)  # the kernel reads them by pointer
        self._head = (Xt.data_ptr(), uvt.data_ptr(), maskf.data_ptr(), intr.data_ptr(), K,
                      ctypes.c_float(delta), self._out.data_ptr())

    def __call__(self, T_cw):
        if self._plain:
            return motion_hessian_gradient_plain(T_cw, *self._args)
        _check_step(T_cw, "T_cw", (4, 4), self._index)
        self._launch(T_cw.data_ptr(), *self._head, build.stream_handle(T_cw))
        motion_hessian_gradient.launches += 1
        return self._views


def motion_hessian_gradient(T_cw, Xt, uvt, maskf, intr, delta):
    """The fused H / g / cost build of :func:`motion_hessian_gradient_plain`.
    T_cw (4,4), Xt (3,K), uvt (2,K), maskf (1,K) float32 {0, 1}; ``intr`` is
    ``motion_intrinsics(cam)``.  One-shot: a fresh ``MotionBuild`` (an LM
    loop keeps one), so the result is a fresh 43-float buffer's views.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    return MotionBuild(Xt, uvt, maskf, intr, delta)(T_cw)


motion_hessian_gradient.launches = 0


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


_PARTIAL_ENTRIES = 28  # a block's pose entries a frame: 21 Hcc, 6 gc, the cost


class LocalBABuild:
    """B7 bound to one ``local_ba`` call: the observations ``obs_uv``
    (F,L,2) float32, ``obs_mask`` (F,L) bool, optional ``obs_ur`` (F,L)
    float32 with ``obs_r_mask`` (F,L) bool, and the camera are checked
    once and kept by pointer, with the (5,) intrinsics and one zeroed
    buffer for the per-block partials and the last-block ticket made once.
    ``build(poses, points)`` -> (Hcc (F,6,6), Hcp (F,L,6,3), Hpp (L,3,3),
    gc (F,6), gp (L,3), cost ()) for poses (F,4,4) and points (L,3): views
    of one fresh buffer, filled by one launch.  Every launch leaves the
    ticket at zero; the partials and ticket are the object's, so its builds
    run on one stream, in order, as an LM loop makes them.

    A missing ``obs_r_mask`` counts every stereo row, as the reference
    kernel's caller does.  CPU tensors take the plain version."""

    def __init__(self, obs_uv, obs_mask, cam, huber_delta: float, obs_ur=None, obs_r_mask=None):
        stereo = obs_ur is not None
        if stereo and obs_r_mask is None:
            obs_r_mask = torch.ones_like(obs_mask)
        F, L = self.F, self.L = obs_mask.shape
        self._plain = obs_mask.device.type == "cpu"
        if self._plain:
            self._args = (obs_uv, obs_mask, cam, huber_delta, obs_ur, obs_r_mask)
            return
        f32 = torch.float32
        intr = local_intrinsics(cam)
        build.check_cuda(obs_uv, "obs_uv", f32, (F, L, 2))
        build.check_cuda(obs_mask, "obs_mask", torch.bool, (F, L))
        build.check_cuda(intr, "camera", f32, (5,))
        if obs_uv.data_ptr() % 8:
            raise ValueError("obs_uv: the kernel reads (u, v) pairs as 8-byte float2")
        if stereo:
            build.check_cuda(obs_ur, "obs_ur", f32, (F, L))
            build.check_cuda(obs_r_mask, "obs_r_mask", torch.bool, (F, L))
        invariant = [obs_uv, obs_mask, intr] + ([obs_ur, obs_r_mask] if stereo else [])
        self._index = obs_mask.get_device()
        if any(x.get_device() != self._index for x in invariant):
            raise ValueError("all tensors must be on one device")
        self._launch = _launcher("ssvo_local_ba_blocks", self._index)
        self._device = obs_mask.device
        # one zeroed buffer: the per-block partials, then the ticket (a word
        # whose zero bits are the uint32 0)
        n_partial = max(1, -(-L // LOCAL_BA_TILE)) * F * _PARTIAL_ENTRIES
        self._scratch = torch.zeros(n_partial + 1, dtype=f32, device=self._device)
        scratch = self._scratch.data_ptr()
        self._tail = (scratch, scratch + 4 * n_partial)
        self._keep = invariant  # the kernel reads them by pointer
        self._head = (obs_uv.data_ptr(), obs_mask.data_ptr(), obs_ur.data_ptr() if stereo else None,
                      obs_r_mask.data_ptr() if stereo else None, intr.data_ptr(), F, L,
                      ctypes.c_float(huber_delta))
        self._sizes = (36 * F, 18 * F * L, 9 * L, 6 * F, 3 * L, 1)
        self._shapes = ((F, 6, 6), (F, L, 6, 3), (L, 3, 3), (F, 6), (L, 3), ())
        self._n_out = sum(self._sizes)

    def __call__(self, poses, points):
        if self._plain:
            return local_ba_blocks_plain(poses, points, *self._args)
        _check_step(poses, "poses", (self.F, 4, 4), self._index)
        _check_step(points, "points", (self.L, 3), self._index)
        out = torch.empty(self._n_out, dtype=torch.float32, device=self._device)
        self._launch(poses.data_ptr(), points.data_ptr(), *self._head, out.data_ptr(), *self._tail,
                     build.stream_handle(poses))
        local_ba_blocks.launches += 1
        return tuple(x.view(shape) for x, shape in zip(out.split(self._sizes), self._shapes))


def local_ba_blocks(poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur=None, obs_r_mask=None):
    """The block build of :func:`local_ba_blocks_plain`'s contract.  poses
    (F,4,4), points (L,3), obs_uv (F,L,2) float32; obs_mask (F,L) bool;
    ``obs_ur`` (F,L) float32 and ``obs_r_mask`` (F,L) bool add the stereo row.
    One-shot: a fresh ``LocalBABuild`` (an LM loop keeps one).

    A missing ``obs_r_mask`` counts every stereo row, as the reference
    kernel's caller does.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    return LocalBABuild(obs_uv, obs_mask, cam, huber_delta, obs_ur, obs_r_mask)(poses, points)


local_ba_blocks.launches = 0
