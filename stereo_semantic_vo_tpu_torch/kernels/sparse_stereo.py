"""Per-keypoint stereo: window costs, and the whole disparity step.

Port of ``stereo_semantic_vo_tpu.kernels.sparse_stereo.keypoint_stereo_costs``
with the same contract (``keypoint_stereo_costs``), and of the per-keypoint
disparity step of ``stereo_semantic_vo_tpu.ops.stereo.sparse_disparity``
around it (``keypoint_disparity``: origins, costs, argmin, uniqueness,
sub-pixel step, gates and depth).  Both launch the one kernel of
``csrc/sparse_stereo.cu``, the step with its epilogue fused.  The plain
versions are the reference's "strips" formulation in strip order, summing
each window in the kernel's fixed order (window row, then column), and the
caller's epilogue as PyTorch ops, so kernel and plain version agree bit for
bit.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.kernels import build

MAX_DISPARITY = 256   # the kernel's strip offsets: 8 a lane of a warp
BIG = 1e9             # the cost of a disparity the image cannot address
_WARPS = 4            # keypoints a block (csrc/sparse_stereo.cu kWarps)
_SMEM_LIMIT = 48 * 1024


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


def _check_window(H: int, W: int, D: int, r: int) -> None:
    """Raise unless the kernel can launch this window on an (H, W) image."""
    P = 2 * r + 1
    smem = 4 * _WARPS * P * (P + 2 + D + 2 * r + 2)
    if r < 0 or not 1 <= D <= MAX_DISPARITY or P > H or smem > _SMEM_LIMIT:
        raise ValueError(f"unsupported window: D={D}, r={r} on {H}x{W} (the kernel takes 1 <= D <= "
                         f"{MAX_DISPARITY}, 2r+1 <= H and {_SMEM_LIMIT} bytes of shared memory a block)")


def keypoint_stereo_costs(
    left, right, y0, xl0, xr0, D: int, r: int, wc: float, wg: float, tc: float, tg: float
) -> torch.Tensor:
    """(H, W) float32 images, (K,) int32 pre-clamped origins of the left
    window (y0, xl0) and right strip (y0, xr0) -> (K, D) costs at strip
    offsets s = D-1-d.

    CPU tensors take the plain version; CUDA tensors launch the kernel with
    its epilogue off."""
    if left.device.type == "cpu":
        return keypoint_stereo_costs_plain(left, right, y0, xl0, xr0, D, r, wc, wg, tc, tg)
    H, W = left.shape
    K = y0.shape[0]
    index = left.get_device()
    build.check_tensors(index, (("left", left, torch.float32, (H, W)), ("right", right, torch.float32, (H, W)),
                                ("y0", y0, torch.int32, (K,)), ("xl0", xl0, torch.int32, (K,)),
                                ("xr0", xr0, torch.int32, (K,))))
    _check_window(H, W, D, r)
    out = torch.empty((K, D), dtype=torch.float32, device=left.device)
    build.call_on(index, "ssvo_keypoint_stereo_costs", left.data_ptr(), right.data_ptr(), H, W, y0.data_ptr(),
                  xl0.data_ptr(), xr0.data_ptr(), K, D, r, wc, wg, tc, tg, out.data_ptr(), build.stream_handle(left))
    keypoint_stereo_costs.launches += 1
    return out


keypoint_stereo_costs.launches = 0


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
    """The caller's epilogue of the TPU kernel: (K, D) strip-order costs and
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


def keypoint_disparity(
    left, right, uv, kp_valid, bf, D: int, r: int, wc: float, wg: float, tc: float, tg: float,
    uniqueness_ratio: float, min_disparity: float,
):
    """(H, W) float32 images, (K, 2) float32 keypoints (x, y), (K,) bool
    validity, the 0-d float32 baseline x fx -> (disparity, depth, valid,
    cost), StereoMatch's fields: (K,) float32 sub-pixel disparity (-1
    invalid), depth (0 invalid), bool valid and the best window cost.

    CPU tensors take the plain version; CUDA tensors launch the kernel once,
    its epilogue fused, counted on ``keypoint_stereo_costs``; disparity,
    depth and cost are views of one (3, K) float32 buffer."""
    if left.device.type == "cpu":
        return keypoint_disparity_plain(left, right, uv, kp_valid, bf, D, r, wc, wg, tc, tg, uniqueness_ratio,
                                        min_disparity)
    H, W = left.shape
    K = uv.shape[0]
    index = left.get_device()
    build.check_tensors(index, (("left", left, torch.float32, (H, W)), ("right", right, torch.float32, (H, W)),
                                ("uv", uv, torch.float32, (K, 2)), ("kp_valid", kp_valid, torch.bool, (K,)),
                                ("bf", bf, torch.float32, ())))
    _check_window(H, W, D, r)
    if W < D + 2 * r:
        raise ValueError(f"unsupported window: the strip of D={D}, r={r} is wider than the image ({W})")
    max_cost = 0.8 * ((wc * tc + wg * tg) * (2 * r + 1) ** 2)
    out = torch.empty((3, K), dtype=torch.float32, device=left.device)
    valid = torch.empty((K,), dtype=torch.bool, device=left.device)
    build.call_on(index, "ssvo_keypoint_disparity", left.data_ptr(), right.data_ptr(), H, W, uv.data_ptr(),
                  kp_valid.data_ptr(), bf.data_ptr(), K, D, r, wc, wg, tc, tg, uniqueness_ratio, min_disparity,
                  max_cost, out.data_ptr(), valid.data_ptr(), build.stream_handle(left))
    keypoint_stereo_costs.launches += 1
    disparity, depth, cost = out.unbind(0)
    return disparity, depth, valid, cost
