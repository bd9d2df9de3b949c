"""Dense stereo's left-based and right-based matching-cost volumes in one
launch.

No TPU kernel: the reference builds the volume in XLA, and the plain
version here is ``ops/dense_stereo.cost_volume`` of each base (a loop over
the disparities, a stack and a 49-term box sum).  The kernel is
``csrc/cost_volume.cu``; it agrees with the plain version on the card bit
for bit, which rests on three things:

- each raw cost is the plain version's float32 operations, each rounded
  on its own (``_rn`` intrinsics, no FMA contraction), with the shifts and
  the x-gradient wrapping at the image border as ``torch.roll`` does;
- the window sum adds its (2r+1)^2 terms one after another in the plain
  version's order, from window position (0, 0) row by row and column by
  column, with +0.0 for a term outside the image (the zero pad), never as
  separable or running sums, which round differently;
- the last step is what PyTorch's CUDA true division by a CPU scalar does:
  a multiply by the float32 reciprocal ``float32(1) / float32((2r+1)^2)``
  (on the CPU, PyTorch divides; the CPU path stays plain).

The grey images only: the colour form of ``cost_volume`` stays plain.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.core.config import StereoConfig
from stereo_semantic_vo_tpu_torch.kernels import build

MAX_DISPARITY = 128  # the kernel's staged match span (csrc/cost_volume.cu kMaxD)
MAX_RADIUS = 7       # the kernel's window: at most 15 x 15


def cost_volumes_plain(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The left-based and right-based ``cost_volume`` of a grey pair."""
    from stereo_semantic_vo_tpu_torch.ops.dense_stereo import cost_volume  # ops imports this module

    return cost_volume(left, right, cfg, False), cost_volume(left, right, cfg, True)


def cost_volumes(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) float32 grey images -> the (H, W, D) float32 left-based and
    right-based cost volumes, D = ``cfg.max_disparity``, with the window
    radius, weights and truncations of ``cfg``.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    for both volumes (1 <= D <= 128, radius <= 7)."""
    if left.device.type == "cpu":
        return cost_volumes_plain(left, right, cfg)
    H, W = left.shape
    D, r = cfg.max_disparity, cfg.block_radius
    if not 1 <= D <= MAX_DISPARITY or not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"the cost-volume kernel takes 1 <= D <= {MAX_DISPARITY} and 0 <= radius <= "
                         f"{MAX_RADIUS}, got D={D}, radius={r}")
    if 2 * H * W * D >= 2**31:
        raise ValueError(f"the cost-volume kernel indexes the volumes with 32-bit offsets, got {H}x{W}x{D}")
    index = left.get_device()
    build.check_tensors(index, (("left", left, torch.float32, (H, W)), ("right", right, torch.float32, (H, W))))
    k = 2 * r + 1
    inv_area = float(np.float32(1.0) / np.float32(k * k))
    out = torch.empty((2, H, W, D), dtype=torch.float32, device=left.device)
    build.call_on(index, "ssvo_dense_cost_volumes", left.data_ptr(), right.data_ptr(), H, W, D, r,
                  cfg.color_weight, cfg.grad_weight, cfg.color_trunc, cfg.grad_trunc, inv_area, out.data_ptr(),
                  build.stream_handle(left))
    cost_volumes.launches += 1
    return out[0], out[1]


cost_volumes.launches = 0
