"""Fundamental-matrix estimation and the epipolar moving-object test: a weighted, Hartley-
normalized 8-point fit over all masked background matches (a 9x9 smallest
eigenvector), hardened by Cauchy IRLS rounds on the Sampson distance, and
the point-to-epipolar-line distance of the dynamic test.

The rank-2 projection U diag(s1, s2, 0) Vt equals F (I - v v^T) with v the
right singular vector of the smallest singular value, taken here as the
smallest eigenvector of F^T F; no SVD is taken.
"""

from __future__ import annotations

import torch

from vo_bench.reference.precision import f32_geometry
from vo_bench.reference.pnp import smallest_eigvec


def _normalize_points(uv: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Hartley normalization: centroid 0, mean distance sqrt(2)."""
    wsum = torch.clamp_min(torch.sum(w), 1e-6)
    mean = torch.sum(uv * w[:, None], dim=0) / wsum
    d = torch.sqrt(torch.sum((uv - mean) ** 2, dim=-1) + 1e-12)
    mean_d = torch.sum(d * w) / wsum
    s = 2.0**0.5 / torch.clamp_min(mean_d, 1e-6)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zero, -s * mean[0]]),
            torch.stack([zero, s, -s * mean[1]]),
            torch.stack([zero, zero, one]),
        ]
    )
    return (uv - mean) * s, T


def _fit_fundamental_once(uv1: torch.Tensor, uv2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One weighted normalized 8-point solve."""
    x1, T1 = _normalize_points(uv1, weight)
    x2, T2 = _normalize_points(uv2, weight)
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1
    )
    F = smallest_eigvec((A * weight[:, None]).T @ A).reshape(3, 3)
    v = smallest_eigvec(F.T @ F)
    F = F - (F @ v)[:, None] * v[None, :]  # rank-2 projection
    F = T2.T @ F @ T1
    return F / torch.clamp_min(torch.abs(F[2, 2]), 1e-9)


def sampson_distance(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """First-order geometric error of the epipolar constraint: (K,) pixels."""
    p1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    p2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=-1)
    l2 = p1 @ F.T
    l1 = p2 @ F
    e = torch.sum(p2 * l2, dim=-1)
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2 + l1[:, 0] ** 2 + l1[:, 1] ** 2
    return torch.abs(e) / torch.sqrt(den + 1e-12)


@f32_geometry
def fit_fundamental(
    uv1: torch.Tensor, uv2: torch.Tensor, weight: torch.Tensor, irls_iters: int = 3
) -> torch.Tensor:
    """Robust weighted 8-point F (3, 3) from (K, 2) correspondences; ``weight``
    zeroes invalid / in-box matches.  l2 = F @ p1h is p1's epiline in image 2."""
    F = _fit_fundamental_once(uv1, uv2, weight)
    for _ in range(irls_iters):
        d = sampson_distance(F, uv1, uv2)
        F = _fit_fundamental_once(uv1, uv2, weight / (1.0 + (d * d) / 1.0))
    return F


def epipolar_distance(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Distance of p2 to the epipolar line of p1: (K,) pixels."""
    p1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    l = p1 @ F.T
    num = torch.abs(torch.sum(l[:, :2] * uv2, dim=-1) + l[:, 2])
    return num / torch.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2 + 1e-12)


def in_box_mask(uv: torch.Tensor, boxes: torch.Tensor, box_valid: torch.Tensor, margin: float) -> torch.Tensor:
    """(K,) bool: is each pixel inside any valid box [x1, y1, x2, y2] grown by ``margin``."""
    x, y = uv[:, 0:1], uv[:, 1:2]
    inside = (
        (x >= boxes[None, :, 0] - margin)
        & (x <= boxes[None, :, 2] + margin)
        & (y >= boxes[None, :, 1] - margin)
        & (y <= boxes[None, :, 3] + margin)
    )
    return torch.any(inside & box_valid[None, :], dim=1)
