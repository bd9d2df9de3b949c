"""The tracker's configuration tree: the same fields and defaults as the
port's ``core/config.py``, built from a benchmark configuration file.

The backend knobs (``fast_backend``, ``patch_backend``, ``sparse_mode``'s
"auto" / "pallas", ``dense_backend``, ``matcher.backend``,
``hessian_backend``, ``local_hessian_backend``) choose a hand-written kernel
in the port; the reference always computes their plain arithmetic, so here
they are read only to tell the sparse modes from "dense".
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    bf: float = 386.1448
    width: int = 1241
    height: int = 376
    fps: float = 10.0
    th_depth: float = 35.0


@dataclasses.dataclass(frozen=True)
class ORBConfig:
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
    steer: bool = True
    fast_backend: str = "xla"
    patch_backend: str = "xla"


@dataclasses.dataclass(frozen=True)
class StereoConfig:
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
    sparse_mode: str = "strips"


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    last_frame_max_dist: int = 15
    local_map_max_dist: int = 30
    local_map_ratio: float = 2.0
    epipolar_threshold: float = 0.1
    box_margin_init: float = 5.0
    box_margin_match: float = 10.0
    search_radius_px: float = 0.0
    backend: str = "popcount"


@dataclasses.dataclass(frozen=True)
class PnPConfig:
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
    iterations: int = 10
    huber_delta: float = 5.991 ** 0.5
    init_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    trim_px: float = 0.0
    local_iterations: int = 5
    max_landmarks: int = 2048
    stereo_pose: bool = False
    hessian_backend: str = "xla"
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


_GROUPS = {"camera": CameraConfig, "orb": ORBConfig, "stereo": StereoConfig, "matcher": MatcherConfig,
           "pnp": PnPConfig, "ba": BAConfig, "semantic": SemanticConfig, "window": WindowConfig}


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
    def from_dict(cls, tree: dict) -> "VOConfig":
        """The configuration whose fields ``tree`` gives (nested groups as
        dicts); an unknown key raises, a missing one takes its default."""
        kw = {}
        for key, value in tree.items():
            group = _GROUPS.get(key)
            kw[key] = group(**value) if group is not None else value
        return cls(**kw)
