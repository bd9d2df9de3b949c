"""Stereo pinhole camera model on tensors.  The intrinsics are float32
0-d tensors on the device of the call, so every division is a true tensor
division in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference.config import CameraConfig


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bf: torch.Tensor  # baseline * fx

    @classmethod
    def from_config(
        cls, cfg: CameraConfig, device: torch.device | str = "cuda", dtype=torch.float32
    ) -> "Camera":
        # torch.full is a device fill, not a host->device copy
        def c(v):
            return torch.full((), v, dtype=dtype, device=device)

        return cls(fx=c(cfg.fx), fy=c(cfg.fy), cx=c(cfg.cx), cy=c(cfg.cy), bf=c(cfg.bf))



def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) * depth / cam.fx
    y = (uv[..., 1] - cam.cy) * depth / cam.fy
    return torch.stack([x, y, depth], dim=-1)


def disparity_to_depth(cam: Camera, disparity: torch.Tensor, min_disp: float = 0.5) -> torch.Tensor:
    """depth = bf / disparity; invalid (<= min_disp) -> 0."""
    valid = disparity > min_disp
    return torch.where(valid, cam.bf / torch.where(valid, disparity, 1.0), 0.0)
