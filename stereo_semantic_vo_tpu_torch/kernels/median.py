"""Small median filters.

Port of ``stereo_semantic_vo_tpu.kernels.median``, which is plain array code
(no hand kernel): edge-replicated padding, the 9 (or 25) shifted views
stacked, and the middle of a sort along the stack.  Sorting is exact, so the
result equals the reference's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _median(img: torch.Tensor, r: int) -> torch.Tensor:
    H, W = img.shape
    P = 2 * r + 1
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    stack = torch.stack([padded[dy : dy + H, dx : dx + W] for dy in range(P) for dx in range(P)])
    return torch.sort(stack, dim=0).values[(P * P) // 2]


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W) 3x3 median (edge-replicated borders)."""
    return _median(img, 1)


def median5x5(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W) 5x5 median."""
    return _median(img, 2)
