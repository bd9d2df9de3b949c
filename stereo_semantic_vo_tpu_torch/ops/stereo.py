"""Stereo disparity at keypoints, the depth source for the VO pipeline.

Port of ``stereo_semantic_vo_tpu.ops.stereo.sparse_disparity`` in its
per-keypoint modes: a (K, D) window cost over D disparities at each
keypoint, then argmin, a uniqueness test, equiangular sub-pixel refinement
and validity gates.

Modes: "pallas" runs the whole per-keypoint step (costs and epilogue) as
one CUDA kernel launch (``kernels/sparse_stereo.keypoint_disparity``; on a
CPU tensor, its plain version) and "strips" runs the plain version
directly; "auto" picks "pallas" on a CUDA device and "strips" on the CPU
(the reference's CPU "auto" picks "volume").  "dense" solves the full
dense disparity (``ops/dense_stereo.py``) and samples it at the keypoints,
as the reference's frame.cc does with MSA.

The whole-image modes run only when asked for, on either device.
"volume" loops over the D disparities: the truncated-difference map of the
right image shifted by d, box-summed "SAME" (zero-padded; row sums, then
column sums, each in window order as the reference's ``reduce_window``)
and sampled at the keypoints.  "volume2" builds the (D, H, W) volume at
once (~90 MB of float32 at 376x1241x48) and box-sums it in two passes.
Both mask the disparities with ``x - d < r`` and share the epilogue of
"strips" (``kernels/sparse_stereo.disparity_epilogue``).  Against "strips"
they differ only in summation order wherever the window lies inside the
image, which holds for every ORB keypoint (border 19 > r).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import torch.nn.functional as F

from stereo_semantic_vo_tpu_torch.core.camera import Camera, disparity_to_depth
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig, resolve_backend
from stereo_semantic_vo_tpu_torch.kernels.fast_score import seq_sum
from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import (
    BIG,
    disparity_epilogue,
    keypoint_disparity,
    keypoint_disparity_plain,
    xgrad,
)
from stereo_semantic_vo_tpu_torch.ops.dense_stereo import dense_disparity


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
    if mode not in ("pallas", "strips", "dense", "volume", "volume2"):
        raise ValueError(f"unknown sparse_mode {mode!r}")
    if mode == "dense":
        return _dense_at_keypoints(left, right, uv, kp_valid, cam, cfg)
    if mode in ("volume", "volume2"):
        costs = volume_costs(left, right, uv, cfg, stacked=mode == "volume2")
        return StereoMatch(*disparity_epilogue(
            costs, kp_valid, cam.bf, cfg.max_disparity, cfg.block_radius, cfg.color_weight, cfg.grad_weight,
            cfg.color_trunc, cfg.grad_trunc, cfg.uniqueness_ratio, cfg.min_disparity,
        )[:4])
    step = keypoint_disparity if mode == "pallas" else keypoint_disparity_plain
    return StereoMatch(*step(
        left, right, uv, kp_valid, cam.bf, cfg.max_disparity, cfg.block_radius,
        cfg.color_weight, cfg.grad_weight, cfg.color_trunc, cfg.grad_trunc,
        cfg.uniqueness_ratio, cfg.min_disparity,
    ))


def _dense_at_keypoints(left, right, uv, kp_valid, cam, cfg: StereoConfig) -> StereoMatch:
    """Dense disparity sampled at the rounded, clipped keypoints, gated on
    the LR-consistent (measured) pixels: refine-repaired disparities are
    inpainted, not observed, and must not seed map points."""
    H, W = left.shape
    x = torch.round(uv[:, 0]).to(torch.int32)  # round half to even, as jnp.round
    y = torch.round(uv[:, 1]).to(torch.int32)
    dd = dense_disparity(left, right, cfg)
    flat = torch.clamp(y, 0, H - 1).to(torch.int64) * W + torch.clamp(x, 0, W - 1)
    disp = dd.disparity.reshape(-1)[flat]
    valid = kp_valid & dd.measured.reshape(-1)[flat] & (disp > cfg.min_disparity)
    depth = torch.where(valid, disparity_to_depth(cam, disp, cfg.min_disparity), 0.0)
    return StereoMatch(
        disparity=torch.where(valid, disp, -1.0), depth=depth, valid=valid, cost=torch.zeros_like(disp)
    )


def box_sum(x: torch.Tensor, P: int) -> torch.Tensor:
    """P x P zero-padded "SAME" window sum over the last two axes: the row
    sums, then the column sums, each in window order."""
    lo, hi = (P - 1) // 2, P - 1 - (P - 1) // 2
    H, W = x.shape[-2:]
    x = F.pad(x, (lo, hi))
    x = seq_sum([x[..., i : i + W] for i in range(P)])
    x = F.pad(x, (0, 0, lo, hi))
    return seq_sum([x[..., i : i + H, :] for i in range(P)])


def volume_costs(left, right, uv, cfg: StereoConfig, stacked: bool = False) -> torch.Tensor:
    """(K, D) window costs in disparity order for modes "volume" (a loop over
    d, one (H, W) map at a time) and "volume2" (``stacked``: the whole
    (D, H, W) volume at once), ``BIG`` where ``x - d < r``."""
    H, W = left.shape
    D, P = cfg.max_disparity, 2 * cfg.block_radius + 1
    x = torch.round(uv[:, 0]).to(torch.int64)  # round half to even, as jnp.round
    y = torch.round(uv[:, 1]).to(torch.int64)
    flat = torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1)
    gl, gr = xgrad(left), xgrad(right)

    def diff(rs, gs):
        ci = torch.clamp_max(torch.abs(left - rs), cfg.color_trunc)
        cg = torch.clamp_max(torch.abs(gl - gs), cfg.grad_trunc)
        return cfg.color_weight * ci + cfg.grad_weight * cg

    if stacked:
        d = torch.arange(D, device=left.device)
        cols = torch.remainder(torch.arange(W, device=left.device)[None, :] - d[:, None], W)  # roll by d
        vol = box_sum(diff(right[:, cols].permute(1, 0, 2), gr[:, cols].permute(1, 0, 2)), P)
        costs = vol.reshape(D, H * W)[:, flat].T
    else:
        costs = torch.stack([
            box_sum(diff(torch.roll(right, d, dims=1), torch.roll(gr, d, dims=1)), P).reshape(-1)[flat]
            for d in range(D)
        ], dim=1)
    addressable = (x[:, None] - torch.arange(D, device=left.device)) >= cfg.block_radius
    return torch.where(addressable, costs, BIG)
