"""The plain arithmetic of the port's hand-written kernels, as the
reference tracker computes it: FAST scores on the rolled ring with the
border mask and 3x3 NMS, patch gathers, the per-keypoint stereo strips and
their epilogue, Hamming distances with the masked best / second-best, the
four SGM sweeps, the 3x3 median, and the local-BA normal-equation blocks
from the materialised Jacobians.  Each sums in the order the port's plain
versions do, which its kernels reproduce (bit for bit, or to float
rounding where the kernel sums in another order: the BA builds).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vo_bench.reference import lie

CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


ARC = 9


def seq_sum(terms):
    """Sum in list order, starting from the first term (a fixed sequential
    reduction order, so float sums agree bit for bit)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def fast_score_rolled(img: torch.Tensor, thresholds: tuple[float, ...]) -> list[torch.Tensor]:
    """FAST-9/16 corner response for every pixel at each threshold.
    img: (H, W) float32 [0, 255].  Returns one (H, W) score per threshold
    (0 where not a corner); the ring uses wrap-around rolls (the
    caller's border mask hides the wrap)."""
    circ = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in CIRCLE])
    diff = circ - img  # (16, H, W)
    shifts = torch.arange(16, device=img.device)[:, None, None]

    def arc_any(bits):
        # circular run of >= ARC set bits in a 16-bit ring mask (int64)
        m = torch.sum(bits.to(torch.int64) << shifts, dim=0)
        m2 = m | (m << 16)
        run = m2
        for k in range(1, ARC):
            run = run & (m2 >> k)
        return (run & 0xFFFF) != 0

    scores = []
    for threshold in thresholds:
        brighter = diff > threshold
        darker = diff < -threshold
        is_corner = arc_any(brighter) | arc_any(darker)
        sb = seq_sum(torch.where(brighter, diff - threshold, 0.0).unbind(0))
        sd = seq_sum(torch.where(darker, -diff - threshold, 0.0).unbind(0))
        scores.append(torch.where(is_corner, torch.maximum(sb, sd), 0.0))
    return scores


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (padding counts as -inf): keep local maxima."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def mask_border(score: torch.Tensor, border: int) -> torch.Tensor:
    """``score`` inside ``[b, H-b) x [b, W-b)``, 0 in the border (the ring
    radius plus the descriptor patch)."""
    H, W = score.shape
    b = border
    inner = torch.zeros_like(score)
    inner[b : H - b, b : W - b] = score[b : H - b, b : W - b]
    return inner


def extract_patches_plain(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, r: int) -> torch.Tensor:
    H, W = img.shape
    P = 2 * r + 1
    ar = torch.arange(P, device=img.device)
    rows = y0.long().clamp(0, H - P)[:, None] + ar
    cols = x0.long().clamp(0, W - P)[:, None] + ar
    return img[rows[:, :, None], cols[:, None, :]]


def extract_patches_levels_plain(
    imgs: Sequence[torch.Tensor], y0: torch.Tensor, x0: torch.Tensor, counts: Sequence[int], r: int
) -> torch.Tensor:
    """The concatenation of the per-level ``extract_patches_plain`` results."""
    ys, xs = torch.split(y0, list(counts)), torch.split(x0, list(counts))
    return torch.cat([extract_patches_plain(img, y, x, r) for img, y, x in zip(imgs, ys, xs)])


BIG = 1e9             # the cost of a disparity the image cannot address


def xgrad(img: torch.Tensor) -> torch.Tensor:
    """(I[x+1] - I[x-1]) * 0.5 with wrap at the image edges."""
    return (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) * 0.5


def keypoint_stereo_costs_plain(
    left, right, y0, xl0, xr0, D: int, r: int, wc: float, wg: float, tc: float, tg: float
) -> torch.Tensor:
    H, W = left.shape
    P = 2 * r + 1
    dev = left.device
    gl, gr = xgrad(left), xgrad(right)
    rows = y0.long().clamp(0, H - P)[:, None, None] + torch.arange(P, device=dev)[None, :, None]
    lc = (xl0.long()[:, None, None] + torch.arange(P, device=dev)) % W
    rc = (xr0.long()[:, None, None] + torch.arange(D + 2 * r, device=dev)) % W
    lp, lg = left[rows, lc], gl[rows, lc]              # (K, P, P)
    rp, rg = right[rows, rc], gr[rows, rc]             # (K, P, D + 2r)
    # window of strip offset s: rp.unfold -> [k, wy, s, wx] = rp[k, wy, s + wx]
    ci = torch.clamp_max(torch.abs(lp[:, :, None, :] - rp.unfold(2, P, 1)), tc)
    cg = torch.clamp_max(torch.abs(lg[:, :, None, :] - rg.unfold(2, P, 1)), tg)
    term = wc * ci + wg * cg                           # (K, P, D, P)
    acc = torch.zeros((y0.shape[0], D), dtype=left.dtype, device=dev)
    for wy in range(P):
        for wx in range(P):
            acc = acc + term[:, wy, :, wx]
    return acc


def keypoint_origins(uv: torch.Tensor, H: int, W: int, D: int, r: int):
    """(K, 2) keypoints (x, y) -> int32 origins (y0, xl0, xr0) of the left
    window and right strip, clamped into the image, and the (K,) ``shift``
    of the strip (> 0 where clamped at the left edge)."""
    P = 2 * r + 1
    Ws = D + 2 * r
    x = torch.round(uv[:, 0]).to(torch.int32)  # round half to even, as jnp.round
    y = torch.round(uv[:, 1]).to(torch.int32)
    y0 = torch.clamp(y - r, 0, H - P)
    xl0 = torch.clamp(x - r, 0, W - P)
    xr0_raw = x - (D - 1) - r
    xr0 = torch.clamp(xr0_raw, 0, W - Ws)
    return y0, xl0, xr0, xr0 - xr0_raw


def disparity_from_costs(
    acc, shift, kp_valid, bf, D: int, r: int, wc: float, wg: float, tc: float, tg: float,
    uniqueness_ratio: float, min_disparity: float,
):
    """The per-keypoint epilogue: (K, D) strip-order costs and
    the (K,) strip shifts -> (disparity, depth, valid, cost, best), the
    first four StereoMatch's fields and ``best`` the argmin disparity."""
    d_idx = torch.arange(D, device=acc.device)[None, :]
    costs = torch.flip(acc, dims=(1,))  # strip offset s = D-1-d -> disparity order
    addressable = (D - 1 - d_idx) >= shift[:, None]
    return disparity_epilogue(torch.where(addressable, costs, BIG), kp_valid, bf, D, r, wc, wg, tc, tg,
                              uniqueness_ratio, min_disparity)


def disparity_epilogue(
    costs, kp_valid, bf, D: int, r: int, wc: float, wg: float, tc: float, tg: float,
    uniqueness_ratio: float, min_disparity: float,
):
    """The disparity-order core of the epilogue, shared by every
    per-keypoint mode: (K, D) costs, ``BIG`` where not addressable ->
    (disparity, depth, valid, cost, best)."""
    P = 2 * r + 1
    d_idx = torch.arange(D, device=costs.device)[None, :]
    best = torch.argmin(costs, dim=1)
    c0 = torch.gather(costs, 1, best[:, None])[:, 0]
    # uniqueness: best must beat the runner-up (excluding +-1 neighbours)
    neighbor = torch.abs(d_idx - best[:, None]) <= 1
    c1 = torch.amin(torch.where(neighbor, BIG, costs), dim=1)
    unique = c0 < uniqueness_ratio * c1

    # equiangular (two-line) sub-pixel interpolation
    cm = torch.gather(costs, 1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    cp = torch.gather(costs, 1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    denom = 2.0 * (torch.maximum(cm, cp) - c0)
    delta = torch.where(denom > 1e-6, (cm - cp) / denom, 0.0)
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    max_win_cost = (wc * tc + wg * tg) * P * P
    valid = (
        kp_valid
        & unique
        & (disp > min_disparity)
        & (best > 0)
        & (best < D - 1)
        & (c0 < 0.8 * max_win_cost)
    )
    # depth = bf / disparity where the disparity clears min_disparity
    # (core.camera.disparity_to_depth), 0 where invalid
    above = disp > min_disparity
    depth = torch.where(valid, torch.where(above, bf / torch.where(above, disp, 1.0), 0.0), 0.0)
    return torch.where(valid, disp, -1.0), depth, valid, c0, best


def keypoint_disparity_plain(
    left, right, uv, kp_valid, bf, D: int, r: int, wc: float, wg: float, tc: float, tg: float,
    uniqueness_ratio: float, min_disparity: float,
):
    """``keypoint_disparity`` in plain PyTorch: the origins, the plain costs
    and the epilogue."""
    H, W = left.shape
    y0, xl0, xr0, shift = keypoint_origins(uv, H, W, D, r)
    acc = keypoint_stereo_costs_plain(left, right, y0, xl0, xr0, D, r, wc, wg, tc, tg)
    return disparity_from_costs(acc, shift, kp_valid, bf, D, r, wc, wg, tc, tg, uniqueness_ratio,
                                min_disparity)[:4]


DESC_BITS = 256


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (SWAR; the masks clear the sign bits
    that arithmetic right shifts bring in)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_distance_matrix(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 -> (Q, T) int32 Hamming distances, one
    descriptor word at a time so no (Q, T, 8) temporary is built."""
    d = torch.zeros((query.shape[0], train.shape[0]), dtype=torch.int32, device=query.device)
    for w in range(query.shape[1]):
        d += popcount32(torch.bitwise_xor(query[:, w, None], train[None, :, w]))
    return d


def masked_best_match(
    dist: torch.Tensor,
    query_valid: torch.Tensor,
    train_valid: torch.Tensor,
    big: int = DESC_BITS + 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise best and second-best over a masked distance matrix.

    Returns (best_idx, best_dist, second_dist), each (Q,) int32; masked
    pairs count as ``big``; ties go to the lower train index (argmin returns
    the first minimum, as ``jnp.argmin`` does)."""
    valid = query_valid[:, None] & train_valid[None, :]
    d = torch.where(valid, dist, big).to(torch.int32)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], big)
    second = torch.amin(d2, dim=1)
    return best_idx.to(torch.int32), best, second


_BIG = 1e9  # the boundary sentinel


def sgm_pass(
    vol: torch.Tensor, p1: float, p2: float, axis: int, reverse: bool,
    p2x: torch.Tensor | None = None,
) -> torch.Tensor:
    """One directional SGM sweep along ``axis`` (0: down the rows, 1: along
    the columns) of an (H, W, D) volume; the reverse sweep walks backward
    from the far end's raw cost.  ``p2x`` (H, W), if given, replaces the
    scalar P2 per position (the current position's value)."""
    moved = vol.movedim(axis, 0)  # (S, X, D)
    S, X, _ = moved.shape
    p2m = None if p2x is None else p2x.movedim(axis, 0)
    big = torch.full((X, 1), _BIG, dtype=vol.dtype, device=vol.device)
    out = torch.empty_like(moved)
    prev = None
    for s in range(S - 1, -1, -1) if reverse else range(S):
        c = moved[s]
        if prev is None:
            prev = c
        else:
            prev_min = torch.amin(prev, dim=-1, keepdim=True)
            shift_m = torch.cat([big, prev[:, :-1]], dim=1)
            shift_p = torch.cat([prev[:, 1:], big], dim=1)
            pen2 = prev_min + (p2 if p2m is None else p2m[s][:, None])
            best = torch.minimum(torch.minimum(prev, pen2), torch.minimum(shift_m + p1, shift_p + p1))
            prev = c + best - prev_min
        out[s] = prev
    return out.movedim(0, axis)


def sgm_aggregate_plain(vol, p1: float, p2: float, p2x_h=None, p2x_v=None) -> torch.Tensor:
    acc = sgm_pass(vol, p1, p2, 1, False, p2x_h)
    acc = acc + sgm_pass(vol, p1, p2, 1, True, p2x_h)
    acc = acc + sgm_pass(vol, p1, p2, 0, False, p2x_v)
    return acc + sgm_pass(vol, p1, p2, 0, True, p2x_v)


def _median(img: torch.Tensor, r: int) -> torch.Tensor:
    H, W = img.shape
    P = 2 * r + 1
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    stack = torch.stack([padded[dy : dy + H, dx : dx + W] for dy in range(P) for dx in range(P)])
    return torch.sort(stack, dim=0).values[(P * P) // 2]


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W) 3x3 median (edge-replicated borders)."""
    return _median(img, 1)


def huber_weights(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber loss on squared residual norms r2."""
    r = torch.sqrt(torch.clamp_min(r2, 1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


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
