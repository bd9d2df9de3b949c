"""Typed configuration for the whole VO pipeline.

The same frozen dataclass tree as ``stereo_semantic_vo_tpu.core.config``:
field names, defaults and ``VOConfig.kitti()`` values are identical, so
``dataclasses.asdict`` of the two packages' configs compares equal and a
config crosses between them through ``interop.config_from_jax``.

Backend strings keep their names.  ``"pallas"`` means "the hand-written
kernel", which in this package is a CUDA kernel; ``"auto"`` resolves by the
device of the tensors a call receives (``resolve_backend``): a CUDA tensor
picks the kernel, a CPU tensor the plain PyTorch version of the same
contract.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def resolve_backend(value: str, device: torch.device | str, gpu: str, cpu: str) -> str:
    """Resolve an ``"auto"`` backend knob for tensors on ``device``."""
    if value != "auto":
        return value
    return gpu if torch.device(device).type == "cuda" else cpu


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Stereo pinhole camera (KITTI 00-02 intrinsics by default)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    bf: float = 386.1448       # baseline * fx  (depth = bf / disparity)
    width: int = 1241
    height: int = 376
    fps: float = 10.0
    th_depth: float = 35.0     # close/far threshold in units of baseline

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @classmethod
    def kitti_00_02(cls) -> "CameraConfig":
        return cls()

    @classmethod
    def kitti_04_12(cls) -> "CameraConfig":
        return cls(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
                   bf=379.8145, width=1226, height=370, th_depth=40.0)


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB frontend on a fixed pyramid with per-cell top-k selection."""

    max_keypoints: int = 512
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20
    fast_min_threshold: int = 7
    patch_size: int = 31
    half_patch: int = 15
    grid_rows: int = 8
    grid_cols: int = 16
    border: int = 19
    descriptor_bits: int = 256
    brief_seed: int = 0x0B5E55ED
    smooth_width: int = 9
    steer: bool = True                # rotate the pattern by the IC angle; False = upright BRIEF
    fast_backend: str = "xla"         # "xla" (rolled ring) | "pallas" (CUDA kernel); "auto" = "xla"
    patch_backend: str = "xla"        # "xla" (plain gather) | "pallas" (CUDA kernel)


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Stereo disparity: sparse epipolar window costs at the keypoints."""

    max_disparity: int = 48
    block_radius: int = 3
    color_weight: float = 0.11
    grad_weight: float = 0.89
    color_trunc: float = 7.0
    grad_trunc: float = 2.0
    p1: float = 1.0
    p2: float = 8.0
    edge_p2: bool = False
    edge_p2_gamma: float = 10.0
    dense_backend: str = "auto"
    lr_consistency_px: float = 1.0
    refine: bool = True
    uniqueness_ratio: float = 0.95
    min_disparity: float = 0.5
    sparse_mode: str = "strips"       # "strips" (plain) | "pallas" (CUDA kernel) | "auto"


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Brute-force 256-bit Hamming matching gates."""

    last_frame_max_dist: int = 15
    local_map_max_dist: int = 30
    local_map_ratio: float = 2.0
    epipolar_threshold: float = 0.1
    box_margin_init: float = 5.0
    box_margin_match: float = 10.0
    search_radius_px: float = 0.0
    backend: str = "popcount"         # "popcount" | "mxu" | "pallas" | "auto"

    def resolved_backend(self, device: torch.device | str) -> str:
        """"pallas" (the fused CUDA kernel) or "popcount".  The TPU's "mxu"
        form computes the same distances, so it maps to "popcount" here."""
        b = resolve_backend(self.backend, device, "pallas", "popcount")
        return "popcount" if b == "mxu" else b


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """Batched RANSAC PnP (see the JAX package for each knob's rationale)."""

    num_hypotheses: int = 256
    sample_size: int = 6
    inlier_px: float = 8.0
    refine_iters: int = 5
    min_inliers: int = 10
    seed: int = 0
    pose_jump_max_m: float = 0.0
    pose_jump_escape_inliers: int = 0
    max_velocity_m: float = 0.0
    seed_bonus: int = 0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Levenberg-Marquardt motion-only bundle adjustment."""

    iterations: int = 10
    huber_delta: float = 5.991 ** 0.5
    init_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    trim_px: float = 0.0
    local_iterations: int = 5
    max_landmarks: int = 2048
    stereo_pose: bool = False
    hessian_backend: str = "xla"        # "xla" (einsum) | "pallas" (CUDA kernel); "auto" = "xla"
    local_hessian_backend: str = "xla"


@dataclasses.dataclass(frozen=True)
class SemanticConfig:
    max_boxes: int = 32
    online_conf_threshold: float = 0.8
    offline_conf_threshold: float = 0.05
    nms_iou: float = 0.45
    input_size: int = 352


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    window_frames: int = 4
    max_map_points: int = 2048


@dataclasses.dataclass(frozen=True)
class VOConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    stereo: StereoConfig = dataclasses.field(default_factory=StereoConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    semantic: SemanticConfig = dataclasses.field(default_factory=SemanticConfig)
    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    use_semantics: bool = True
    use_local_map: bool = True
    dtype: str = "float32"

    @classmethod
    def kitti(cls, sequence: str = "00") -> "VOConfig":
        """KITTI intrinsics and the main path's knobs: upright BRIEF, and the
        three kernels (patches, sparse stereo, matcher) behind "auto"."""
        seq = int(sequence)
        cam = CameraConfig.kitti_00_02() if seq <= 3 else CameraConfig.kitti_04_12()
        return cls(
            camera=cam,
            orb=ORBConfig(steer=False, patch_backend="auto"),
            matcher=MatcherConfig(backend="auto", search_radius_px=150.0),
            pnp=PnPConfig(pose_jump_max_m=1.5, seed_bonus=8, max_velocity_m=4.0),
            stereo=StereoConfig(sparse_mode="auto", edge_p2=True, edge_p2_gamma=5.0),
            ba=BAConfig(local_hessian_backend="auto", trim_px=10.0),
        )

    @property
    def image_shape(self) -> Tuple[int, int]:
        return (self.camera.height, self.camera.width)
