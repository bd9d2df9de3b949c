"""Stereo disparity at keypoints, the depth source for the VO pipeline.

Port of ``stereo_semantic_vo_tpu.ops.stereo.sparse_disparity`` in its
per-keypoint modes: a (K, D) window cost over D disparities at each
keypoint, then argmin, a uniqueness test, equiangular sub-pixel refinement
and validity gates.

Modes: "pallas" runs the whole per-keypoint step (costs and epilogue) as
one CUDA kernel launch (``kernels/sparse_stereo.keypoint_disparity``; on a
CPU tensor, its plain version) and "strips" runs the plain version
directly; "auto" picks "pallas" on a CUDA device and "strips" on the CPU.  "dense" solves the full dense disparity
(``ops/dense_stereo.py``) and samples it at the keypoints, as the
reference's frame.cc does with MSA.  The cost-volume modes "volume" and
"volume2" are not ported yet (ROADMAP A4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_semantic_vo_tpu_torch.core.camera import Camera, disparity_to_depth
from stereo_semantic_vo_tpu_torch.core.config import StereoConfig, resolve_backend
from stereo_semantic_vo_tpu_torch.ops.dense_stereo import dense_disparity
from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import (
    keypoint_disparity,
    keypoint_disparity_plain,
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
        raise NotImplementedError(f"sparse_mode={mode!r} is not ported yet (ROADMAP A4)")
    if mode == "dense":
        return _dense_at_keypoints(left, right, uv, kp_valid, cam, cfg)
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
