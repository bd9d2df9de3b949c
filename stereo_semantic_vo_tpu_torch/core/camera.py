"""Stereo pinhole camera model on tensors.

Port of ``stereo_semantic_vo_tpu.core.camera``.  The intrinsics are float32
0-d tensors on the device of the call, as the JAX package keeps them on its
device, so every division is a true tensor division in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_semantic_vo_tpu_torch.core.config import CameraConfig


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

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx]),
                torch.stack([z, self.fy, self.cy]),
                torch.stack([z, z, o]),
            ]
        )


def project(cam: Camera, pts_cam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> pixel coords (..., 2) and depth (...,)."""
    z = pts_cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    u = cam.fx * pts_cam[..., 0] / safe_z + cam.cx
    v = cam.fy * pts_cam[..., 1] / safe_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) * depth / cam.fx
    y = (uv[..., 1] - cam.cy) * depth / cam.fy
    return torch.stack([x, y, depth], dim=-1)


def disparity_to_depth(cam: Camera, disparity: torch.Tensor, min_disp: float = 0.5) -> torch.Tensor:
    """depth = bf / disparity; invalid (<= min_disp) -> 0."""
    valid = disparity > min_disp
    return torch.where(valid, cam.bf / torch.where(valid, disparity, 1.0), 0.0)


def right_keypoint_x(uv: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """x_r = x_l - d."""
    return uv[..., 0] - disparity
