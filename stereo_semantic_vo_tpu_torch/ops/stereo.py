"""Stereo disparity at keypoints, the depth source for the VO pipeline.

Port of ``stereo_semantic_vo_tpu.ops.stereo.sparse_disparity`` in its
per-keypoint modes: a (K, D) window cost over D disparities at each
keypoint, then argmin, a uniqueness test, equiangular sub-pixel refinement
and validity gates.

Modes: "pallas" computes the costs with the CUDA kernel
(``kernels/sparse_stereo.py``; on a CPU tensor, its plain version) and
"strips" with the plain version directly; "auto" picks "pallas" on a CUDA
device and "strips" on the CPU.  "dense" solves the full dense disparity
(``ops/dense_stereo.py``) and samples it at the keypoints, as the
reference's frame.cc does with MSA.  The cost-volume modes "volume" and
"volume2" are not ported yet (ROADMAP A3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_semantic_vo_tpu_torch.core.camera import Camera, disparity_to_depth
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig, resolve_backend
from stereo_semantic_vo_tpu_torch.ops.dense_stereo import dense_disparity
from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import (
    keypoint_stereo_costs,
    keypoint_stereo_costs_plain,
)


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
    mode = resolve_backend(cfg.sparse_mode, left.device, "pallas", "strips")
    if mode not in ("pallas", "strips", "dense"):
        raise NotImplementedError(f"sparse_mode={mode!r} is not ported yet (ROADMAP A3)")
    H, W = left.shape
    x = torch.round(uv[:, 0]).to(torch.int32)  # round half to even, as jnp.round
    y = torch.round(uv[:, 1]).to(torch.int32)
    if mode == "dense":
        return _dense_at_keypoints(left, right, x, y, kp_valid, cam, cfg)
    D = cfg.max_disparity
    r = cfg.block_radius
    P = 2 * r + 1
    Ws = D + 2 * r
    big = 1e9
    d_idx = torch.arange(D, device=left.device)[None, :]

    y0 = torch.clamp(y - r, 0, H - P)
    xl0 = torch.clamp(x - r, 0, W - P)
    xr0_raw = x - (D - 1) - r
    xr0 = torch.clamp(xr0_raw, 0, W - Ws)
    shift = xr0 - xr0_raw  # >0 where clamped at the image edge
    costs_fn = keypoint_stereo_costs if mode == "pallas" else keypoint_stereo_costs_plain
    acc = costs_fn(
        left, right, y0, xl0, xr0, D, r,
        cfg.color_weight, cfg.grad_weight, cfg.color_trunc, cfg.grad_trunc,
    )
    costs = torch.flip(acc, dims=(1,))  # strip offset s = D-1-d -> disparity order
    addressable = (D - 1 - d_idx) >= shift[:, None]
    costs = torch.where(addressable, costs, big)

    best = torch.argmin(costs, dim=1)
    c0 = torch.gather(costs, 1, best[:, None])[:, 0]
    # uniqueness: best must beat the runner-up (excluding +-1 neighbours)
    neighbor = torch.abs(d_idx - best[:, None]) <= 1
    c1 = torch.amin(torch.where(neighbor, big, costs), dim=1)
    unique = c0 < cfg.uniqueness_ratio * c1

    # equiangular (two-line) sub-pixel interpolation
    cm = torch.gather(costs, 1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    cp = torch.gather(costs, 1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    denom = 2.0 * (torch.maximum(cm, cp) - c0)
    delta = torch.where(denom > 1e-6, (cm - cp) / denom, 0.0)
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    max_win_cost = (cfg.color_weight * cfg.color_trunc + cfg.grad_weight * cfg.grad_trunc) * P * P
    valid = (
        kp_valid
        & unique
        & (disp > cfg.min_disparity)
        & (best > 0)
        & (best < D - 1)
        & (c0 < 0.8 * max_win_cost)
    )
    depth = torch.where(valid, disparity_to_depth(cam, disp, cfg.min_disparity), 0.0)
    return StereoMatch(disparity=torch.where(valid, disp, -1.0), depth=depth, valid=valid, cost=c0)


def _dense_at_keypoints(left, right, x, y, kp_valid, cam, cfg: StereoConfig) -> StereoMatch:
    """Dense disparity sampled at the rounded, clipped keypoints, gated on
    the LR-consistent (measured) pixels: refine-repaired disparities are
    inpainted, not observed, and must not seed map points."""
    H, W = left.shape
    dd = dense_disparity(left, right, cfg)
    flat = torch.clamp(y, 0, H - 1).to(torch.int64) * W + torch.clamp(x, 0, W - 1)
    disp = dd.disparity.reshape(-1)[flat]
    valid = kp_valid & dd.measured.reshape(-1)[flat] & (disp > cfg.min_disparity)
    depth = torch.where(valid, disparity_to_depth(cam, disp, cfg.min_disparity), 0.0)
    return StereoMatch(
        disparity=torch.where(valid, disp, -1.0), depth=depth, valid=valid, cost=torch.zeros_like(disp)
    )
