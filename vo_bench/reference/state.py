"""Fixed-shape tracker state: last-frame keypoints and a ring-buffer local
map.  The W-frame sliding-window map is a ring of W*K slots where slot
``(f % W) * K + k`` holds the map point attached to keypoint ``k`` of frame
``f``.  ``frame_idx`` is a 0-d int32 tensor; descriptors are int32 bit
patterns of 32-bit words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference.config import VOConfig


class VOState(NamedTuple):
    frame_idx: torch.Tensor     # () int32 index of the last processed frame (-1: none)
    T_cw: torch.Tensor          # (4, 4) pose of the last processed frame
    velocity: torch.Tensor      # (4, 4) last frame <- frame before it

    last_uv: torch.Tensor       # (K, 2)
    last_desc: torch.Tensor     # (K, 8) int32
    last_valid: torch.Tensor    # (K,) bool

    map_Xw: torch.Tensor        # (M, 3) world positions, M = W * K
    map_desc: torch.Tensor      # (M, 8) int32 descriptor snapshots
    map_valid: torch.Tensor     # (M,) slot occupied
    map_bad: torch.Tensor       # (M,) judged dynamic (epipolar test)
    map_create_id: torch.Tensor  # (M,) int32 creating frame index
    map_uid: torch.Tensor       # (M,) int32 landmark id (creation frame * K + kp)

    win_T_cw: torch.Tensor      # (W, 4, 4) pose of each window frame
    win_uv: torch.Tensor        # (W, K, 2) keypoint pixels of each window frame
    win_disp: torch.Tensor      # (W, K) stereo disparity per keypoint (-1 none)


def init_state(cfg: VOConfig, device: torch.device | str) -> VOState:
    K = cfg.orb.max_keypoints
    Wf = cfg.window.window_frames
    M = Wf * K
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(4, dtype=f32, device=device)
    return VOState(
        frame_idx=torch.full((), -1, dtype=i32, device=device),
        T_cw=eye.clone(),
        velocity=eye.clone(),
        last_uv=z((K, 2)),
        last_desc=z((K, 8), i32),
        last_valid=z((K,), torch.bool),
        map_Xw=z((M, 3)),
        map_desc=z((M, 8), i32),
        map_valid=z((M,), torch.bool),
        map_bad=z((M,), torch.bool),
        map_create_id=torch.full((M,), -100, dtype=i32, device=device),
        map_uid=torch.full((M,), -1, dtype=i32, device=device),
        win_T_cw=eye.repeat(Wf, 1, 1),
        win_uv=z((Wf, K, 2)),
        win_disp=torch.full((Wf, K), -1.0, dtype=f32, device=device),
    )


class TrackOutputs(NamedTuple):
    """Per-frame diagnostics and observation bindings (device tensors)."""

    T_cw: torch.Tensor
    T_wc: torch.Tensor
    n_keypoints: torch.Tensor
    n_stereo: torch.Tensor
    n_matches_last: torch.Tensor
    n_matches_map: torch.Tensor
    n_pnp_inliers: torch.Tensor
    n_ba_inliers: torch.Tensor
    n_new_points: torch.Tensor
    n_culled_dynamic: torch.Tensor
    pnp_ok: torch.Tensor
    kp_uv: torch.Tensor     # (K, 2) current keypoint pixels
    obs_uid: torch.Tensor   # (K,) uid of the map point each kp observes (-1 none)
    obs_valid: torch.Tensor  # (K,) kp has a bound map point (matched or created)
