"""Stereo disparity at keypoints: the per-keypoint strips, or the dense
disparity (cost volumes, 4-path SGM, winner take all with sub-pixel
refinement, left/right check, an LR-guided refine pass and a 3x3 median)
sampled at the keypoints.

The sparse modes ("strips", and "pallas" / "auto", whose kernel computes
the same) take a (K, D) window cost over D disparities at each keypoint,
then argmin, a uniqueness test, equiangular sub-pixel refinement and
validity gates.  The dense volume rolls wrap at the image border, and the
7x7 box sum accumulates in its sequential window order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vo_bench.reference.camera import Camera, disparity_to_depth
from vo_bench.reference.config import StereoConfig
from vo_bench.reference.plain import keypoint_disparity_plain, median3x3, sgm_aggregate_plain


class StereoMatch(NamedTuple):
    disparity: torch.Tensor  # (K,) float32 sub-pixel disparity (level-0 px), -1 invalid
    depth: torch.Tensor      # (K,) float32, 0 where invalid
    valid: torch.Tensor      # (K,) bool
    cost: torch.Tensor       # (K,) float32 best matching cost (diagnostics)


def sparse_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    uv: torch.Tensor,
    kp_valid: torch.Tensor,
    cam: Camera,
    cfg: StereoConfig,
) -> StereoMatch:
    """Per-keypoint epipolar window correlation.

    left/right: (H, W) float32 grayscale in [0, 255]; uv: (K, 2) float32
    keypoint pixel coords (x, y) in the left image."""
    if cfg.sparse_mode not in ("auto", "pallas", "strips", "dense"):
        raise ValueError(f"sparse_mode {cfg.sparse_mode!r} has no reference here")
    if cfg.sparse_mode == "dense":
        return _dense_at_keypoints(left, right, uv, kp_valid, cam, cfg)
    return StereoMatch(*keypoint_disparity_plain(
        left, right, uv, kp_valid, cam.bf, cfg.max_disparity, cfg.block_radius,
        cfg.color_weight, cfg.grad_weight, cfg.color_trunc, cfg.grad_trunc,
        cfg.uniqueness_ratio, cfg.min_disparity,
    ))


def _dense_at_keypoints(left, right, uv, kp_valid, cam, cfg: StereoConfig) -> StereoMatch:
    """Dense disparity sampled at the rounded, clipped keypoints, gated on
    the LR-consistent (measured) pixels: refine-repaired disparities are
    inpainted, not observed, and must not seed map points."""
    H, W = left.shape
    x = torch.round(uv[:, 0]).to(torch.int32)  # round half to even
    y = torch.round(uv[:, 1]).to(torch.int32)
    dd = dense_disparity(left, right, cfg)
    flat = torch.clamp(y, 0, H - 1).to(torch.int64) * W + torch.clamp(x, 0, W - 1)
    disp = dd.disparity.reshape(-1)[flat]
    valid = kp_valid & dd.measured.reshape(-1)[flat] & (disp > cfg.min_disparity)
    depth = torch.where(valid, disparity_to_depth(cam, disp, cfg.min_disparity), 0.0)
    return StereoMatch(
        disparity=torch.where(valid, disp, -1.0), depth=depth, valid=valid, cost=torch.zeros_like(disp)
    )


class DenseDisparity(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32, -1 where invalid
    valid: torch.Tensor      # (H, W) bool: measured, or repaired by the refine pass
    measured: torch.Tensor   # (H, W) bool: passed the LR check (depth consumers gate on it)


def _xgrad(img: torch.Tensor) -> torch.Tensor:
    return (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) * 0.5


def _box_sum(vol: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1) x (2r+1) zero-padded "SAME" window sum over the first two
    axes, accumulated in window order (row, then column)."""
    H, W = vol.shape[:2]
    k = 2 * r + 1
    padded = F.pad(vol, (0, 0, r, r, r, r))
    acc = padded[:H, :W]
    for i in range(1, k * k):
        dy, dx = divmod(i, k)
        acc = acc + padded[dy : dy + H, dx : dx + W]
    return acc


def cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    right_base: bool = False,
    left_rgb: torch.Tensor | None = None,
    right_rgb: torch.Tensor | None = None,
) -> torch.Tensor:
    """(H, W, D) matching cost: cost(x, d) compares left(x) with right(x-d)
    (or right(x) with left(x+d) when ``right_base``), mixing truncated
    absolute intensity and x-gradient differences with the MSA weights.
    With ``left_rgb`` / ``right_rgb`` (H, W, 3) the colour term is the
    channel mean of the absolute differences, truncated after averaging;
    the gradient term always comes from the grey images."""
    D = cfg.max_disparity
    gl, gr = _xgrad(left), _xgrad(right)
    use_rgb = left_rgb is not None and right_rgb is not None

    def shift(img, d):
        return torch.roll(img, -d if right_base else d, dims=1)

    if use_rgb:
        base_i, match_i = (right_rgb, left_rgb) if right_base else (left_rgb, right_rgb)
    else:
        base_i, match_i = (right, left) if right_base else (left, right)
    base_g, match_g = (gr, gl) if right_base else (gl, gr)

    costs = []
    for d in range(D):
        diff = torch.abs(base_i - shift(match_i, d))
        if use_rgb:
            # a sequential sum times the float32 reciprocal
            diff = (diff[..., 0] + diff[..., 1] + diff[..., 2]) * (1.0 / 3.0)
        ci = torch.clamp_max(diff, cfg.color_trunc)
        cg = torch.clamp_max(torch.abs(base_g - shift(match_g, d)), cfg.grad_trunc)
        costs.append(cfg.color_weight * ci + cfg.grad_weight * cg)
    vol = torch.stack(costs, dim=-1)
    k = 2 * cfg.block_radius + 1
    return _box_sum(vol, cfg.block_radius) / (k * k)


def edge_p2_planes(base: torch.Tensor, cfg: StereoConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position P2 for the horizontal / vertical sweeps:
    P2'(p) = p1 + (p2 - p1) * exp(-|dI(p)| / gamma), dI the central
    gradient along the sweep axis (wrapping at the border)."""
    gx = torch.abs(_xgrad(base))
    gy = torch.abs((torch.roll(base, -1, dims=0) - torch.roll(base, 1, dims=0)) * 0.5)
    inv_g = 1.0 / cfg.edge_p2_gamma
    lo, span = cfg.p1, cfg.p2 - cfg.p1
    return lo + span * torch.exp(-gx * inv_g), lo + span * torch.exp(-gy * inv_g)


def sgm_aggregate_batch(
    vols: list[torch.Tensor],
    cfg: StereoConfig,
    planes: list[tuple[torch.Tensor | None, torch.Tensor | None]] | None = None,
    scale: float = 1.0,
) -> list[torch.Tensor]:
    """4-path SGM (horizontal both ways, then vertical both ways) of
    same-shape volumes.
    ``planes`` holds each volume's optional (p2x_h, p2x_v) per-position P2
    planes; ``scale`` multiplies every penalty (the refine pass runs at 0.5)."""
    p1, p2 = cfg.p1 * scale, cfg.p2 * scale
    planes = planes or [(None, None)] * len(vols)
    p2x_h = [None if h is None else h * scale for h, _ in planes]
    p2x_v = [None if v is None else v * scale for _, v in planes]
    return [sgm_aggregate_plain(v, p1, p2, h, w) for v, h, w in zip(vols, p2x_h, p2x_v)]


def sgm_aggregate(
    vol: torch.Tensor,
    cfg: StereoConfig,
    p2x_h: torch.Tensor | None = None,
    p2x_v: torch.Tensor | None = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """``sgm_aggregate_batch`` of one volume."""
    return sgm_aggregate_batch([vol], cfg, [(p2x_h, p2x_v)], scale)[0]


def _wta_subpixel(agg: torch.Tensor, min_disp: float) -> torch.Tensor:
    """(H, W, D) -> (H, W) winner-take-all disparity (ties to the lower d)
    with equiangular sub-pixel refinement."""
    D = agg.shape[-1]
    best = torch.argmin(agg, dim=-1, keepdim=True)
    c0 = torch.gather(agg, -1, best)[..., 0]
    cm = torch.gather(agg, -1, torch.clamp(best - 1, 0, D - 1))[..., 0]
    cp = torch.gather(agg, -1, torch.clamp(best + 1, 0, D - 1))[..., 0]
    denom = 2.0 * (torch.maximum(cm, cp) - c0)
    delta = torch.where(denom > 1e-6, (cm - cp) / denom, 0.0)
    return best[..., 0].to(torch.float32) + torch.clamp(delta, -0.5, 0.5)


def dense_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    left_rgb: torch.Tensor | None = None,
    right_rgb: torch.Tensor | None = None,
) -> DenseDisparity:
    """Full dense pipeline with LR consistency.  left/right: (H, W) float32
    grey; optionally the (H, W, 3) colour images for the 3-channel cost."""
    p2h_l = p2v_l = p2h_r = p2v_r = None
    if cfg.edge_p2:
        p2h_l, p2v_l = edge_p2_planes(left, cfg)
        p2h_r, p2v_r = edge_p2_planes(right, cfg)

    vols = [cost_volume(left, right, cfg, rb, left_rgb, right_rgb) for rb in (False, True)]
    agg_l, agg_r = sgm_aggregate_batch(vols, cfg, [(p2h_l, p2v_l), (p2h_r, p2v_r)])
    del vols
    disp_l = _wta_subpixel(agg_l, cfg.min_disparity)
    disp_r = _wta_subpixel(agg_r, cfg.min_disparity)
    del agg_l, agg_r

    # LR check: d_l(x) vs d_r(x - d_l(x))
    H, W = left.shape
    xs = torch.arange(W, dtype=torch.int32, device=left.device).expand(H, W)
    xr = torch.clamp(xs - torch.round(disp_l).to(torch.int32), 0, W - 1)
    d_r_at = torch.gather(disp_r, 1, xr.to(torch.int64))
    consistent = torch.abs(disp_l - d_r_at) <= cfg.lr_consistency_px
    # disparity-range border: the first D columns cannot see their match
    in_range = xs - disp_l >= 0
    valid = consistent & in_range & (disp_l > cfg.min_disparity)
    measured = valid

    if cfg.refine:
        # re-aggregate a cost reset from the LR verdict at half the
        # smoothing: consistent pixels anchor at |d - d1|, failed ones cost
        # 0, so aggregation fills them from their consistent neighbours
        d_axis = torch.arange(cfg.max_disparity, dtype=torch.float32, device=left.device)
        vol_ref = torch.where(valid[..., None], torch.abs(d_axis - disp_l[..., None]), 0.0)
        disp_ref = _wta_subpixel(sgm_aggregate(vol_ref, cfg, p2h_l, p2v_l, scale=0.5), cfg.min_disparity)
        disp_l = torch.where(valid, disp_l, disp_ref)
        valid = in_range & (disp_l > cfg.min_disparity)

    disp = median3x3(torch.where(valid, disp_l, 0.0))
    disp = torch.where(valid, disp, -1.0)
    return DenseDisparity(disparity=disp, valid=valid, measured=measured & valid)
