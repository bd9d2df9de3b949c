"""Dense disparity: cost volume, semi-global scanline aggregation, winner
take all with sub-pixel refinement, left/right check and an LR-guided
refinement pass.

Port of ``stereo_semantic_vo_tpu.ops.dense_stereo`` (the reference's
stand-in for MSA's spanning-tree solve), with the same functions and
outputs.  The aggregation dispatches on ``StereoConfig.dense_backend``:
"pallas" is the CUDA scanline kernel (``kernels/sgm_scan.py``; on a CPU
tensor its plain version), "xla" the plain scan; "auto" picks the kernel on
a CUDA device and the plain scan on the CPU.  ``dense_disparity`` hands the
left and right volumes to one aggregation call, so the kernel sweeps both
in the same launches.  The same knob picks how the two volumes are built
(``cost_volumes``): "pallas" is the CUDA kernel of ``kernels/cost_volume.py``,
both grey volumes in one launch, "xla" ``cost_volume`` of each base, the
plain loop that the kernel is held to bit for bit.

Reproduced as the reference has them: the ``jnp.roll`` wraps at the image
border (in the cost volume and the P2 planes) and the 7x7 box sum in its
sequential window order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereo_semantic_vo_tpu_torch.core.config import StereoConfig, resolve_backend
from stereo_semantic_vo_tpu_torch.kernels import cost_volume as cost_volume_kernel
from stereo_semantic_vo_tpu_torch.kernels import sgm_scan
from stereo_semantic_vo_tpu_torch.kernels.median import median3x3

_sgm_pass = sgm_scan.sgm_pass  # the reference's plain directional sweep


class DenseDisparity(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32, -1 where invalid
    valid: torch.Tensor      # (H, W) bool: measured, or repaired by the refine pass
    measured: torch.Tensor   # (H, W) bool: passed the LR check (depth consumers gate on it)


def _xgrad(img: torch.Tensor) -> torch.Tensor:
    return (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) * 0.5


def _box_sum(vol: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1) x (2r+1) zero-padded "SAME" window sum over the first two
    axes, accumulated in window order (row, then column) like the
    reference's reduce_window."""
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
            # jnp.mean's order: a sequential sum times the float32 reciprocal
            diff = (diff[..., 0] + diff[..., 1] + diff[..., 2]) * (1.0 / 3.0)
        ci = torch.clamp_max(diff, cfg.color_trunc)
        cg = torch.clamp_max(torch.abs(base_g - shift(match_g, d)), cfg.grad_trunc)
        costs.append(cfg.color_weight * ci + cfg.grad_weight * cg)
    vol = torch.stack(costs, dim=-1)
    k = 2 * cfg.block_radius + 1
    return _box_sum(vol, cfg.block_radius) / (k * k)


def cost_volumes(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    left_rgb: torch.Tensor | None = None,
    right_rgb: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """The left-based and right-based ``cost_volume`` of a pair.  Grey
    images under ``dense_backend`` "pallas" ("auto" on a CUDA tensor) take
    the kernel, one launch for both; the colour form and "xla" build each
    volume with ``cost_volume``."""
    use_rgb = left_rgb is not None and right_rgb is not None
    if not use_rgb and resolve_backend(cfg.dense_backend, left.device, "pallas", "xla") == "pallas":
        return list(cost_volume_kernel.cost_volumes(left, right, cfg))
    return [cost_volume(left, right, cfg, rb, left_rgb, right_rgb) for rb in (False, True)]


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
    same-shape volumes that the kernel aggregates in the same launches.
    ``planes`` holds each volume's optional (p2x_h, p2x_v) per-position P2
    planes; ``scale`` multiplies every penalty (the refine pass runs at 0.5)."""
    p1, p2 = cfg.p1 * scale, cfg.p2 * scale
    planes = planes or [(None, None)] * len(vols)
    p2x_h = [None if h is None else h * scale for h, _ in planes]
    p2x_v = [None if v is None else v * scale for _, v in planes]
    backend = resolve_backend(cfg.dense_backend, vols[0].device, "pallas", "xla")
    if backend == "pallas":
        return sgm_scan.sgm_aggregate_batch(vols, p1, p2, p2x_h, p2x_v)
    return sgm_scan.sgm_aggregate_batch_plain(vols, p1, p2, p2x_h, p2x_v)


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

    # both volumes live at once (2 x 89.6 MB at 1241x376x48) so one
    # aggregation call, two kernel launches, covers them
    vols = cost_volumes(left, right, cfg, left_rgb, right_rgb)
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
