"""FAST-9/16 corner scores for one or two thresholds from one ring read.

Port of ``stereo_semantic_vo_tpu.kernels.fast_score.fast_scores_pallas``;
the kernel is ``csrc/fast_score.cu``.  Its contract is the TPU kernel's: the
image is zero outside its edge (a 3-px zero halo), where ``fast_score_rolled``,
the reference's XLA form, wraps around.  The two agree on ``[3:-3, 3:-3]``;
``extract_orb`` masks a 19-px border, so its keypoints do not depend on
which of the two scored the level.

The ring, the run test and the sequential sums live here, and
``ops/orb.py`` imports them: one copy of the FAST arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stereo_semantic_vo_tpu_torch.kernels import build

# FAST-9/16 Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
ARC = 9
RADIUS = 3
MAX_THRESHOLDS = 2


def seq_sum(terms):
    """Sum in list order, starting from the first term (the reference's
    sequential reduction order, so float sums agree bit for bit)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def fast_score_rolled(img: torch.Tensor, thresholds: tuple[float, ...]) -> list[torch.Tensor]:
    """FAST-9/16 corner response for every pixel at each threshold.
    img: (H, W) float32 [0, 255].  Returns one (H, W) score per threshold
    (0 where not a corner); the ring uses wrap-around rolls, as the
    reference's XLA form does (the caller's border mask hides the wrap)."""
    circ = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in CIRCLE])
    diff = circ - img  # (16, H, W)
    shifts = torch.arange(16, device=img.device)[:, None, None]

    def arc_any(bits):
        # circular run of >= ARC set bits in a 16-bit ring mask (int64)
        m = torch.sum(bits.to(torch.int64) << shifts, dim=0)
        m2 = m | (m << 16)
        run = m2
        for k in range(1, ARC):
            run = run & (m2 >> k)
        return (run & 0xFFFF) != 0

    scores = []
    for threshold in thresholds:
        brighter = diff > threshold
        darker = diff < -threshold
        is_corner = arc_any(brighter) | arc_any(darker)
        sb = seq_sum(torch.where(brighter, diff - threshold, 0.0).unbind(0))
        sd = seq_sum(torch.where(darker, -diff - threshold, 0.0).unbind(0))
        scores.append(torch.where(is_corner, torch.maximum(sb, sd), 0.0))
    return scores


def fast_scores_plain(img: torch.Tensor, thresholds: tuple[float, ...]) -> list[torch.Tensor]:
    """The kernel's contract in plain PyTorch: ``fast_score_rolled`` on the
    image zero-padded by the ring radius, cropped back to (H, W)."""
    r = RADIUS
    padded = F.pad(img, (r, r, r, r))
    return [s[r:-r, r:-r] for s in fast_score_rolled(padded, thresholds)]


def fast_scores(img: torch.Tensor, thresholds: tuple[float, ...]) -> list[torch.Tensor]:
    """(H, W) float32 image, 1 or 2 thresholds -> one (H, W) float32 score
    map per threshold, zero halo (the views of one (n, H, W) buffer).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if img.device.type == "cpu":
        return fast_scores_plain(img, thresholds)
    if img.dim() != 2:
        raise ValueError(f"img: expected (H, W), got shape {tuple(img.shape)}")
    H, W = img.shape
    build.check_cuda(img, "img", torch.float32, (H, W))
    n = len(thresholds)
    if not 1 <= n <= MAX_THRESHOLDS:
        raise ValueError(f"the FAST kernel takes 1 or {MAX_THRESHOLDS} thresholds, got {n}")
    th = [float(x) for x in thresholds] + [0.0] * (MAX_THRESHOLDS - n)
    lib = build.library()
    out = torch.empty((n, H, W), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        lib.call("ssvo_fast_scores", img.data_ptr(), H, W, n, th[0], th[1], out.data_ptr(),
                 build.stream_handle(img))
    fast_scores.launches += 1
    return list(out.unbind(0))


fast_scores.launches = 0
