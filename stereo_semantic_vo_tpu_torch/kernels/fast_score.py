"""FAST-9/16 corner scores for one or two thresholds from one ring read,
and the all-levels form with ``extract_orb``'s border mask and 3x3 NMS.

Port of ``stereo_semantic_vo_tpu.kernels.fast_score.fast_scores_pallas``;
the kernel is ``csrc/fast_score.cu``.  Its contract is the TPU kernel's: the
image is zero outside its edge (a 3-px zero halo), where ``fast_score_rolled``,
the reference's XLA form, wraps around.  The two agree on ``[3:-3, 3:-3]``;
``extract_orb`` masks a 19-px border, so its keypoints do not depend on
which of the two scored the level.

``fast_scores_levels`` is what ``extract_orb`` calls with
``fast_backend="pallas"``: one launch for every pyramid level of a frame,
with the composition the reference runs on each level's scores
(``stereo_semantic_vo_tpu/ops/orb.py:337-343``) fused.  ``fast_scores``
keeps the TPU kernel's raw one-level contract: the same kernel with its
epilogue off.

The ring, the run test, the sequential sums and the NMS live here, and
``ops/orb.py`` imports them: one copy of the FAST arithmetic.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

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
MAX_LEVELS = 8  # the kernel's level table


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


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (padding counts as -inf): keep local maxima."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def mask_border(score: torch.Tensor, border: int) -> torch.Tensor:
    """``score`` inside ``[b, H-b) x [b, W-b)``, 0 in the border (the ring
    radius plus the descriptor patch)."""
    H, W = score.shape
    b = border
    inner = torch.zeros_like(score)
    inner[b : H - b, b : W - b] = score[b : H - b, b : W - b]
    return inner


def fast_scores_levels_plain(
    levels: Sequence[torch.Tensor], thresholds: tuple[float, ...], border: int
) -> list[list[torch.Tensor]]:
    """The fused kernel's contract in plain PyTorch: per level and
    threshold, ``nms3(mask_border(fast_scores_plain(img, ths)[j], border))``."""
    return [[nms3(mask_border(s, border)) for s in fast_scores_plain(img, thresholds)] for img in levels]


def _launch(levels: Sequence[torch.Tensor], thresholds: tuple[float, ...], border: int, fused: bool) -> torch.Tensor:
    """One launch over every level -> the (n_th, sum H_l*W_l) float32
    buffer, each threshold's plane holding the levels in order.  Counts on
    ``fast_scores_levels``."""
    n, L = len(thresholds), len(levels)
    if not 1 <= n <= MAX_THRESHOLDS:
        raise ValueError(f"the FAST kernel takes 1 or {MAX_THRESHOLDS} thresholds, got {n}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the FAST kernel takes 1 to {MAX_LEVELS} levels, got {L}")
    # the level table, each image checked once with cheap attribute reads
    dev = levels[0].device
    index = levels[0].get_device()
    if dev.type != "cuda":
        raise ValueError(f"levels: expected CUDA tensors, got {dev}")
    ptrs, Hs, Ws = (ctypes.c_void_p * L)(), (ctypes.c_int * L)(), (ctypes.c_int * L)()
    total = 0
    for l, img in enumerate(levels):
        if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous() or img.get_device() != index:
            raise ValueError(f"levels[{l}]: expected a contiguous (H, W) float32 image on {dev}, got "
                             f"{img.dtype} {tuple(img.shape)} on {img.device}")
        H, W = img.shape
        ptrs[l], Hs[l], Ws[l] = img.data_ptr(), H, W
        total += H * W
    th = [float(x) for x in thresholds] + [0.0] * (MAX_THRESHOLDS - n)
    lib = build.library()
    out = torch.empty((n, total), dtype=torch.float32, device=dev)
    args = (ptrs, Hs, Ws, L, n, th[0], th[1], border, int(fused), out.data_ptr(), build.stream_handle(out))
    if index == torch.cuda.current_device():
        lib.call("ssvo_fast_scores_levels", *args)
    else:
        with torch.cuda.device(dev):
            lib.call("ssvo_fast_scores_levels", *args)
    fast_scores_levels.launches += 1
    return out


def fast_scores_levels(
    levels: Sequence[torch.Tensor], thresholds: tuple[float, ...], border: int
) -> list[list[torch.Tensor]]:
    """(H_l, W_l) float32 level images (at most 8 on the card), 1 or 2
    thresholds, the border width -> for each level, one (H_l, W_l) float32
    map per threshold: the FAST scores with the border zeroed and 3x3
    non-max suppression, as ``extract_orb`` selects from them.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    for all levels, and the maps are views of one (n_th, sum H_l*W_l)
    buffer."""
    if border < 0:
        raise ValueError(f"border must be >= 0, got {border}")
    if levels[0].device.type == "cpu":
        return fast_scores_levels_plain(levels, thresholds, border)
    out = _launch(levels, thresholds, border, fused=True)
    planes = out.split([img.numel() for img in levels], dim=1)
    return [list(p.view(len(thresholds), *img.shape).unbind(0)) for p, img in zip(planes, levels)]


fast_scores_levels.launches = 0


def fast_scores(img: torch.Tensor, thresholds: tuple[float, ...]) -> list[torch.Tensor]:
    """(H, W) float32 image, 1 or 2 thresholds -> one (H, W) float32 raw
    score map per threshold, zero halo (the TPU kernel's contract; the
    views of one (n, H, W) buffer).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    one level with its epilogue off, counted on ``fast_scores_levels``."""
    if img.device.type == "cpu":
        return fast_scores_plain(img, thresholds)
    if img.dim() != 2:
        raise ValueError(f"img: expected (H, W), got shape {tuple(img.shape)}")
    H, W = img.shape
    return list(_launch([img], thresholds, 0, fused=False).view(len(thresholds), H, W).unbind(0))
