"""ORB feature frontend: FAST-9/16 on a fixed pyramid, grid top-k selection
and BRIEF descriptors, upright or steered, all with static shapes.

Top-k selection uses a stable descending sort (ties to the lower index);
FAST sums, the box blur and the window reductions accumulate in a fixed
sequential order; the pyramid is resized with the separable triangle-kernel
weight matrices of a linear, antialiased resize, applied as
``Ry @ img @ Rx``.  Descriptors are (K, 8) int32 bit patterns of 32-bit
words.  Every level's patches come from one plain gather.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vo_bench.reference.config import ORBConfig
from vo_bench.reference.plain import extract_patches_levels_plain, fast_score_rolled, mask_border, nms3, seq_sum
from vo_bench.reference.precision import f32_matmul


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (all tensors length K = cfg.max_keypoints)."""

    uv: torch.Tensor        # (K, 2) float32, level-0 pixel coordinates (x, y)
    response: torch.Tensor  # (K,) float32 FAST score
    angle: torch.Tensor     # (K,) float32 radians (0 when upright)
    level: torch.Tensor     # (K,) int32 pyramid level
    valid: torch.Tensor     # (K,) bool
    desc: torch.Tensor      # (K, 8) int32 packed 256-bit descriptors


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int, n_bits: int = 256, patch: int = 31) -> np.ndarray:
    """Deterministic BRIEF point-pair pattern: (n_bits, 4) int32 = (y1,x1,y2,x2)."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    sigma = patch / 5.0
    lim = patch // 2
    pts = np.clip(np.round(rng.randn(n_bits, 4) * sigma), -lim, lim).astype(np.int32)
    return pts


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a linear resize along one axis:
    the triangle kernel, widened by the scale factor
    when downsampling (antialias), columns normalized, samples outside the
    input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    # (i + 0.5) * inv_scale - 0.5 rounded once, as a fused multiply-add
    # computes it (exact in float64: both factors have 24-bit mantissas)
    centers = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (centers * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32).T.copy()


@functools.lru_cache(maxsize=None)
def _resize_matrices(H: int, W: int, Hn: int, Wn: int, device: torch.device):
    """Device-resident (Hn, H) and (W, Wn) resize weights, built once."""
    Ry = torch.from_numpy(resize_matrix(H, Hn)).to(device)
    Rx = torch.from_numpy(resize_matrix(W, Wn).T.copy()).to(device)
    return Ry, Rx


def resize_linear(img: torch.Tensor, Hn: int, Wn: int) -> torch.Tensor:
    """The linear, antialiased resize of ``img`` to (Hn, Wn) as ``Ry @ img @ Rx``
    (an axis that keeps its size gets the identity matrix, which is exact)."""
    H, W = img.shape
    Ry, Rx = _resize_matrices(H, W, Hn, Wn, img.device)
    return (Ry @ img) @ Rx


def _grid_topk(score: torch.Tensor, rows: int, cols: int, k_cell: int):
    """Top-k responses per grid cell -> ((rows*cols*k_cell,) flat pixel index,
    score), ties to the lower in-cell index."""
    H, W = score.shape
    ch, cw = H // rows, W // cols
    s = score[: ch * rows, : cw * cols].reshape(rows, ch, cols, cw).permute(0, 2, 1, 3)
    s = s.reshape(rows * cols, ch * cw)
    top, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_cell], idx[:, :k_cell]
    cell_ids = torch.arange(rows * cols, device=score.device)
    py = ((cell_ids // cols) * ch)[:, None] + idx // cw
    px = ((cell_ids % cols) * cw)[:, None] + idx % cw
    return (py * W + px).reshape(-1), top.reshape(-1)


def _smooth(img: torch.Tensor, width: int = 5) -> torch.Tensor:
    """width x width box blur, zero-padded "SAME", summed row then column in
    window order."""
    lo = (width - 1) // 2
    hi = width - 1 - lo
    H, W = img.shape
    x = F.pad(img, (lo, hi))
    x = seq_sum([x[:, i : i + W] for i in range(width)])
    x = F.pad(x, (0, 0, lo, hi))
    x = seq_sum([x[i : i + H] for i in range(width)])
    return x * (1.0 / (width * width))


def _patch_origins(shape: tuple[int, int], xy: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left (y0, x0) int32 origins of the P x P patches around integer
    keypoints xy (x, y), clamped into an image of ``shape``."""
    H, W = shape
    P = 2 * r + 1
    y0 = torch.clamp(xy[:, 1] - r, 0, H - P).to(torch.int32)
    x0 = torch.clamp(xy[:, 0] - r, 0, W - P).to(torch.int32)
    return y0, x0


@functools.lru_cache(maxsize=None)
def _pair_indices(seed: int, n_bits: int, patch: int, device: torch.device):
    """Flat (P*P) indices of the two endpoints of every BRIEF pair."""
    pts = brief_pattern(seed, n_bits, patch).astype(np.int64)
    r = patch // 2
    P = 2 * r + 1
    i1 = (pts[:, 0] + r) * P + (pts[:, 1] + r)
    i2 = (pts[:, 2] + r) * P + (pts[:, 3] + r)
    return torch.from_numpy(i1).to(device), torch.from_numpy(i2).to(device)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 bit patterns (bit j of word w = bit 32w+j)."""
    words = bits.reshape(bits.shape[0], 8, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    packed = torch.sum(words << shifts, dim=-1)           # [0, 2^32)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def _describe_upright(patches: torch.Tensor, seed: int, n_bits: int, patch: int) -> torch.Tensor:
    """Upright BRIEF from (N, P, P) patches: the pair endpoints selected by
    index."""
    i1, i2 = _pair_indices(seed, n_bits, patch, patches.device)
    flat = patches.reshape(patches.shape[0], -1)
    return _pack_bits(flat[:, i1] < flat[:, i2])


@functools.lru_cache(maxsize=None)
def _ic_weights(half: int, device: torch.device) -> torch.Tensor:
    """(P*P, 2) intensity-centroid weights (dx, dy) inside the radius-``half``
    circle of a P x P patch, P = 2*half + 1; zero outside it."""
    r = half
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    circle = (dx * dx + dy * dy) <= r * r
    w = np.stack([dx * circle, dy * circle], axis=-1).reshape(-1, 2).astype(np.float32)
    return torch.from_numpy(w).to(device)


def ic_moments(patches: torch.Tensor, half: int) -> torch.Tensor:
    """(N, P, P) patches -> (N, 2) circular moments (m10, m01), accumulated
    in full float32 (TF32 off): a rounded moment jitters the angle and flips
    outer-radius BRIEF bits."""
    with f32_matmul():
        return patches.reshape(patches.shape[0], -1) @ _ic_weights(half, patches.device)


def orientation_from_patches(patches: torch.Tensor, half: int) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) of (N, P, P) patches."""
    m = ic_moments(patches, half)
    return torch.atan2(m[:, 1], m[:, 0])


@functools.lru_cache(maxsize=None)
def _pattern(seed: int, n_bits: int, patch: int, device: torch.device) -> torch.Tensor:
    """The BRIEF pattern as a (n_bits, 4) float32 device tensor."""
    return torch.from_numpy(brief_pattern(seed, n_bits, patch).astype(np.float32)).to(device)


def describe(img_s: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: rotate the (n_bits, 4) (y1, x1, y2, x2) pattern by each
    keypoint's angle, round the samples half to even, clamp them into the
    smoothed (H, W) image and compare -> (N, 8) int32 packed words.
    ``xy`` (N, 2) integer keypoints (x, y), ``angle`` (N,) radians."""
    H, W = img_s.shape
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    p = pattern.to(torch.float32)
    ky = xy[:, 1:2].to(torch.float32)
    kx = xy[:, 0:1].to(torch.float32)
    flat = img_s.reshape(-1)

    def sample(py, px):
        rx = ca * px[None, :] - sa * py[None, :]
        ry = sa * px[None, :] + ca * py[None, :]
        sy = torch.clamp(torch.round(ky + ry), 0, H - 1).to(torch.int64)
        sx = torch.clamp(torch.round(kx + rx), 0, W - 1).to(torch.int64)
        return flat[sy * W + sx]

    return _pack_bits(sample(p[:, 0], p[:, 1]) < sample(p[:, 2], p[:, 3]))


def _level_budgets(cfg: ORBConfig, n_candidates: int) -> list[int]:
    """Geometric per-level candidate budget ~ 1/scale^l, ORB-SLAM2 style."""
    inv = [1.0 / (cfg.scale_factor**l) for l in range(cfg.n_levels)]
    s = sum(inv)
    return [max(8, int(round(n_candidates * w / s))) for w in inv]


def pyramid(image: torch.Tensor, cfg: ORBConfig) -> list[torch.Tensor]:
    """The ``cfg.n_levels`` level images ``extract_orb`` scores, finest
    first; each side shrinks by ``scale_factor`` and stops at 32 px."""
    levels = [image]
    for _ in range(cfg.n_levels - 1):
        Hl, Wl = levels[-1].shape
        Hn = max(int(round(Hl / cfg.scale_factor)), 32)
        Wn = max(int(round(Wl / cfg.scale_factor)), 32)
        levels.append(resize_linear(levels[-1], Hn, Wn))
    return levels


def extract_orb(image: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """Full ORB pipeline on one grayscale image (H, W) float32 in [0, 255].

    Returns a fixed-capacity :class:`Keypoints` (K = cfg.max_keypoints),
    ranked by response, with validity masks for unfilled slots."""
    dev = image.device
    budgets = _level_budgets(cfg, 2 * cfg.max_keypoints)
    bonus = 1e6  # strong corners outrank weak-cell fallbacks
    two_pass = cfg.fast_min_threshold < cfg.fast_threshold
    ths = (
        (float(cfg.fast_threshold), float(cfg.fast_min_threshold))
        if two_pass
        else (float(cfg.fast_threshold),)
    )
    b = cfg.border
    # steered: the angle's patches (radius half_patch); upright: BRIEF's
    r = cfg.half_patch if cfg.steer else cfg.patch_size // 2

    all_uv, all_rank, all_score, all_level, all_valid = [], [], [], [], []
    smoothed, all_xy, all_y0, all_x0, counts = [], [], [], [], []
    levels = pyramid(image, cfg)
    for level, img_l in enumerate(levels):
        Hl, Wl = img_l.shape
        # kill borders (circle radius + patch), then NMS
        scores = [nms3(mask_border(sc, b)) for sc in fast_score_rolled(img_l, ths)]
        if two_pass:
            hi, lo = scores
            resp = torch.where(hi > 0.0, hi, lo)
            rank = torch.where(hi > 0.0, hi + bonus, lo)
        else:
            resp = rank = scores[0]

        k_cell = max(1, math.ceil(budgets[level] / (cfg.grid_rows * cfg.grid_cols)))
        flat_idx, s = _grid_topk(rank, cfg.grid_rows, cfg.grid_cols, k_cell)
        xy = torch.stack([flat_idx % Wl, flat_idx // Wl], dim=-1)
        smoothed.append(_smooth(img_l, cfg.smooth_width))
        all_xy.append(xy)
        y0, x0 = _patch_origins((Hl, Wl), xy, r)
        all_y0.append(y0)
        all_x0.append(x0)
        counts.append(xy.shape[0])

        all_uv.append(xy.to(torch.float32) * (cfg.scale_factor**level))
        all_rank.append(s)
        all_score.append(resp.reshape(-1)[flat_idx])
        all_level.append(torch.full(s.shape, level, dtype=torch.int32, device=dev))
        all_valid.append(s > 0.0)

    patches = extract_patches_levels_plain(smoothed, torch.cat(all_y0), torch.cat(all_x0), counts, r)
    if cfg.steer:
        # the IC angle of every keypoint at once, then the rotated pattern
        # gathered from each smoothed level
        angle = orientation_from_patches(patches, cfg.half_patch)
        pattern = _pattern(cfg.brief_seed, cfg.descriptor_bits, cfg.patch_size, dev)
        desc = torch.cat([describe(img_s, xy, a, pattern)
                          for img_s, xy, a in zip(smoothed, all_xy, torch.split(angle, counts))])
    else:
        # upright BRIEF on all the patches at once
        angle = torch.zeros(sum(counts), dtype=image.dtype, device=dev)
        desc = _describe_upright(patches, cfg.brief_seed, cfg.descriptor_bits, cfg.patch_size)

    rank = torch.cat(all_rank)
    valid = torch.cat(all_valid)
    ranked = torch.where(valid, rank, -1.0)
    top_r, top_i = torch.sort(ranked, descending=True, stable=True)
    top_r, top_i = top_r[: cfg.max_keypoints], top_i[: cfg.max_keypoints]
    return Keypoints(
        uv=torch.cat(all_uv)[top_i],
        response=torch.cat(all_score)[top_i],
        angle=angle[top_i],
        level=torch.cat(all_level)[top_i],
        valid=top_r > 0.0,
        desc=desc[top_i],
    )
