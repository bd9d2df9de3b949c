"""RANSAC PnP with a fixed batch of hypotheses solved at once:
``num_hypotheses`` Hartley-normalized minimal DLT solves as one batch of
12x12 inverse iterations, every hypothesis scored against every
correspondence as a (B, K) tensor, the best (optionally the
constant-velocity seed) polished with LM.

The samples are a Gumbel top-k under ``jax.random``'s threefry-2x32 bits
for ``fold_in(PRNGKey(seed), t)``, computed with integer ops (int64 masked
to 32 bits), so the same ``(seed, t)`` gives the same (B, S) indices on
any device.  Failed Cholesky factorizations give NaN (the hypothesis then
scores 0 inliers), and the 3x3 SVD of ``_P_to_T`` is a scaled Newton
polar decomposition with closed-form 3x3 inverses and determinants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference import lie
from vo_bench.reference.camera import Camera
from vo_bench.reference.config import BAConfig, PnPConfig
from vo_bench.reference.precision import f32_geometry
from vo_bench.reference import ba as ba_ops


class PnPResult(NamedTuple):
    T_cw: torch.Tensor         # (4, 4) world->camera
    inlier_mask: torch.Tensor  # (K,)
    n_inliers: torch.Tensor    # ()
    ok: torch.Tensor           # () bool: enough inliers to trust the pose


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) as adjugate / determinant (NaN or inf if singular)."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    adj = torch.stack(
        [torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0), torch.linalg.cross(r0, r1)], dim=-1
    )
    return adj / det3(M)[..., None, None]


def polar3(M: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Orthogonal polar factor U @ Vt of a nonsingular (..., 3, 3) matrix by
    Newton's iteration with Frobenius-norm scaling (Higham), which reaches
    float32 precision within a few steps for conditions up to ~1e6."""
    X = M
    for _ in range(iters):
        Xi = inv3(X)
        g = torch.sqrt(
            torch.linalg.matrix_norm(Xi) / torch.linalg.matrix_norm(X)
        )[..., None, None]
        X = 0.5 * (g * X + Xi.transpose(-1, -2) / g)
    return X


def smallest_right_singular_vector3(M: torch.Tensor, squarings: int = 5) -> torch.Tensor:
    """Right singular vector of the smallest singular value of a nonsingular
    3x3 matrix: (M^T M)^-1 = M^-1 M^-T raised to the power 2^squarings
    (normalized at each step) has every column parallel to it."""
    Mi = inv3(M)
    B = Mi @ Mi.T
    for _ in range(squarings):
        B = B / torch.linalg.matrix_norm(B)
        B = B @ B
    # index_select, not B[:, i]: indexing with a 0-d device tensor reads it back
    col = B.index_select(1, torch.argmax(torch.linalg.vector_norm(B, dim=0)).reshape(1))[:, 0]
    return col / torch.linalg.vector_norm(col)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of ``jax.random`` (20 rounds) on int64
    tensors holding uint32 values; the key words are ints or tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_key(seed: int, t: torch.Tensor | None = None, device=None) -> tuple:
    """``jax.random.PRNGKey(seed)``, folded with the frame counter ``t``
    (a 0-d integer tensor) as ``jax.random.fold_in`` does, as two uint32
    words (int64 0-d tensors once ``t`` is given)."""
    k0, k1 = (seed >> 32) & _M32, seed & _M32
    if t is None:
        return k0, k1
    zero = torch.zeros((), dtype=torch.int64, device=t.device)
    return _threefry2x32(k0, k1, zero, t.to(torch.int64) & _M32)


def sample_indices(key: tuple, valid: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(B, S) distinct indices of valid correspondences per hypothesis: the
    Gumbel top-k under ``key``.  The Gumbel score is monotone in
    its uniform, whose order is that of the 23 mantissa bits of
    ``jax.random.uniform``; ties go to the lower index, and masked entries
    rank below every valid one (lowest index first)."""
    K = valid.shape[0]
    count = torch.arange(B * K, dtype=torch.int64, device=valid.device).reshape(B, K)
    b0, b1 = _threefry2x32(*key, torch.zeros_like(count), count)
    mant = (b0 ^ b1) >> 9
    tie = (K - 1) - torch.arange(K, dtype=torch.int64, device=valid.device)
    score = torch.where(valid[None, :], (mant + 1) * K + tie, tie)
    return torch.topk(score, S, dim=1).indices


def smallest_eigvec(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of small PSD matrices (..., n, n)
    by shifted inverse iteration.  The shifted matrix is inverted once
    through its Cholesky factor (one triangular solve against the identity;
    a batched triangular solve costs far more host time than a matmul on a
    CUDA device), then each of the ``iters`` steps is a matrix-vector
    product.  A failed factorization gives NaN."""
    n = M.shape[-1]
    trace = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    shift = (1e-6 * trace / n + 1e-12)[..., None, None]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M + shift * eye)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    Linv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    Ainv = Linv.transpose(-1, -2) @ Linv
    x = torch.full(M.shape[:-1] + (1,), 1.0 / float(n) ** 0.5, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        y = Ainv @ x
        x = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-2, keepdim=True), 1e-30)
    return x[..., 0]


def _dlt_pose(Xs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Minimal DLT, batched: (..., S, 3) world points + (..., S, 2)
    normalized image points -> (..., 3, 4) projective pose [M | t], with the
    world side centred and scaled to RMS sqrt(3) first, sign-fixed so sample
    depths are positive and scaled so |det M| = 1."""
    c = Xs.mean(dim=-2)
    rms = torch.sqrt(torch.mean(torch.sum((Xs - c[..., None, :]) ** 2, dim=-1), dim=-1) + 1e-12)
    s = 3.0**0.5 / torch.clamp_min(rms, 1e-6)
    Xn = (Xs - c[..., None, :]) * s[..., None, None]
    ones = torch.ones(Xs.shape[:-1] + (1,), dtype=Xs.dtype, device=Xs.device)
    Xh_n = torch.cat([Xn, ones], dim=-1)                       # (..., S, 4)
    zeros = torch.zeros_like(Xh_n)
    u, v = xs[..., 0:1], xs[..., 1:2]
    rows_u = torch.cat([Xh_n, zeros, -u * Xh_n], dim=-1)       # (..., S, 12)
    rows_v = torch.cat([zeros, Xh_n, -v * Xh_n], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                    # (..., 2S, 12)
    p = smallest_eigvec(A.transpose(-1, -2) @ A)
    Pn = p.reshape(p.shape[:-1] + (3, 4))
    # denormalize: X_n = s (X - c)  =>  P = Pn @ [[s I, -s c], [0, 1]]
    N4 = torch.zeros(Xs.shape[:-2] + (4, 4), dtype=Xs.dtype, device=Xs.device)
    N4[..., :3, :3] = s[..., None, None] * torch.eye(3, dtype=Xs.dtype, device=Xs.device)
    N4[..., :3, 3] = -s[..., None] * c
    N4[..., 3, 3].fill_(1.0)
    P = Pn @ N4
    depth = torch.cat([Xs, ones], dim=-1) @ P[..., 2, :, None]  # (..., S, 1)
    sign = torch.where(torch.sum(torch.sign(depth), dim=(-2, -1)) >= 0, 1.0, -1.0)[..., None, None]
    scale = torch.pow(torch.abs(det3(P[..., :3] * sign)) + 1e-12, 1.0 / 3.0)[..., None, None]
    return P * sign / scale


def _project_P(P: torch.Tensor, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Project (K, 3) world points with (..., 3, 4) projective poses
    (normalized camera) -> ((..., K, 2), (..., K))."""
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
    pr = Xh @ P.transpose(-1, -2)                              # (..., K, 3)
    z = pr[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    return pr[..., :2] / safe_z[..., None], z


def _P_to_T(P: torch.Tensor) -> torch.Tensor:
    """Orthonormalize a (3, 4) projective pose into a rigid (4, 4) transform:
    R = U diag(1, 1, det(U Vt)) Vt, t = P[:, 3] / mean(singular values)."""
    M3 = P[:, :3]
    Q = polar3(M3)                                   # U @ Vt
    scale = torch.sum(Q * M3) / 3.0                  # trace(Q^T M3) / 3 = mean(s)
    v = smallest_right_singular_vector3(M3)
    eye = torch.eye(3, dtype=P.dtype, device=P.device)
    R = torch.where(det3(M3) < 0, Q @ (eye - 2.0 * v[:, None] * v[None, :]), Q)
    return lie.rt_to_T(R, P[:, 3] / torch.clamp_min(scale, 1e-9))


@f32_geometry
def ransac_pnp(
    X_w: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    cam: Camera,
    cfg: PnPConfig,
    t: torch.Tensor | None = None,
    refine_cfg: BAConfig | None = None,
    T_seed: torch.Tensor | None = None,
    ur: torch.Tensor | None = None,
    ur_mask: torch.Tensor | None = None,
    idx: torch.Tensor | None = None,
) -> PnPResult:
    """Estimate T_cw from (K, 3) world points and (K, 2) pixel observations.

    ``idx`` (B, S) gives the samples; otherwise they are drawn under
    ``fold_in(PRNGKey(cfg.seed), t)`` (``PRNGKey(cfg.seed)`` if ``t`` is
    None).
    ``T_seed`` (4x4) replaces hypothesis 0 with the motion-model prediction."""
    B, S = cfg.num_hypotheses, cfg.sample_size
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    if idx is None:
        idx = sample_indices(random_key(cfg.seed, t), valid, B, S)
    idx = idx.to(device=X_w.device, dtype=torch.int64)
    Ps = _dlt_pose(X_w[idx], xn[idx])                          # (B, 3, 4)
    if T_seed is not None:
        Ps = torch.cat([T_seed[None, :3, :], Ps[1:]], dim=0)

    proj, z = _project_P(Ps, X_w)                              # (B, K, 2), (B, K)
    err = torch.stack([proj[..., 0] * cam.fx, proj[..., 1] * cam.fy], dim=-1) - torch.stack(
        [xn[:, 0] * cam.fx, xn[:, 1] * cam.fy], dim=-1
    )[None]
    e2 = torch.sum(err * err, dim=-1)
    inl = valid[None, :] & (e2 < cfg.inlier_px**2) & (z > 0.05)
    counts = torch.sum(inl, dim=1)
    if T_seed is not None and cfg.seed_bonus > 0:
        counts[0] += cfg.seed_bonus  # a sampled pose must beat the prior by a margin
    best = torch.argmax(counts).reshape(1)  # a 1-d index: no readback
    T0 = _P_to_T(Ps.index_select(0, best)[0])
    best_inl = inl.index_select(0, best)[0]

    rcfg = refine_cfg or BAConfig(iterations=cfg.refine_iters)
    res = ba_ops.motion_only_ba(
        T0, X_w, uv, best_inl, cam, rcfg, use_huber=False, ur=ur, ur_mask=ur_mask
    )
    # recount inliers at the refined pose; keep the unrefined one if
    # refinement lost consensus
    r, zf = ba_ops.reprojection_residuals(res.T_cw, X_w, uv, cam)
    final_inl = valid & (torch.sum(r * r, dim=-1) < cfg.inlier_px**2) & (zf > 0.05)
    use_refined = torch.sum(final_inl) >= torch.sum(best_inl)
    T = torch.where(use_refined, res.T_cw, T0)
    inl_out = torch.where(use_refined, final_inl, best_inl)
    n_out = torch.sum(inl_out)
    return PnPResult(T_cw=T, inlier_mask=inl_out, n_inliers=n_out, ok=n_out >= cfg.min_inliers)
