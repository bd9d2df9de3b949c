"""Batched square-patch extraction at keypoint origins, all pyramid levels
of a frame at once.

Port of ``stereo_semantic_vo_tpu.kernels.patch_extract.extract_patches``;
the kernel is ``csrc/patch_extract.cu``.  The TPU kernel wrote (K, 32, 128)
slabs for its tiling, one call per level; this one writes tight (K, P, P)
patches, P = 2r+1, for up to 8 level images in one launch.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from stereo_semantic_vo_tpu_torch.kernels import build

MAX_LEVELS = 8  # the kernel's level table


def extract_patches_plain(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, r: int) -> torch.Tensor:
    H, W = img.shape
    P = 2 * r + 1
    ar = torch.arange(P, device=img.device)
    rows = y0.long().clamp(0, H - P)[:, None] + ar
    cols = x0.long().clamp(0, W - P)[:, None] + ar
    return img[rows[:, :, None], cols[:, None, :]]


def extract_patches_levels_plain(
    imgs: Sequence[torch.Tensor], y0: torch.Tensor, x0: torch.Tensor, counts: Sequence[int], r: int
) -> torch.Tensor:
    """The concatenation of the per-level ``extract_patches_plain`` results."""
    ys, xs = torch.split(y0, list(counts)), torch.split(x0, list(counts))
    return torch.cat([extract_patches_plain(img, y, x, r) for img, y, x in zip(imgs, ys, xs)])


def extract_patches_levels(
    imgs: Sequence[torch.Tensor], y0: torch.Tensor, x0: torch.Tensor, counts: Sequence[int], r: int
) -> torch.Tensor:
    """(H_l, W_l) float32 level images (at most 8 on the card), the
    concatenated (sum K_l,) int32 top-left origins (each pre-clamped into
    its level) and the host ints K_l -> (sum K_l, P, P) float32 patches,
    level 0's first.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    for all levels."""
    counts = [int(c) for c in counts]
    if len(imgs) != len(counts) or not imgs:
        raise ValueError(f"expected images with one count each, got {len(imgs)} and {len(counts)}")
    if y0.device.type == "cpu":
        return extract_patches_levels_plain(imgs, y0, x0, counts, r)
    if len(imgs) > MAX_LEVELS:
        raise ValueError(f"the patch kernel takes at most {MAX_LEVELS} levels, got {len(imgs)}")
    K, P, dev = sum(counts), 2 * r + 1, y0.device
    build.check_cuda(y0, "y0", torch.int32, (K,))
    build.check_cuda(x0, "x0", torch.int32, (K,))
    if x0.device != dev:
        raise ValueError("all tensors must be on one device")
    # the level table, each image checked once; the checks read cheap
    # attributes only: this call's host time is most of B1's time a frame
    n, index = len(imgs), y0.get_device()
    ptrs, Hs, Ws, first = (ctypes.c_void_p * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    start = 0
    for l, (img, k) in enumerate(zip(imgs, counts)):
        if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous() or img.get_device() != index:
            raise ValueError(f"imgs[{l}]: expected a contiguous (H, W) float32 image on {dev}, got "
                             f"{img.dtype} {tuple(img.shape)} on {img.device}")
        H, W = img.shape
        if not (P <= H and P <= W):
            raise ValueError(f"patch {P} larger than level {l}'s image {H}x{W}")
        if k < 0:
            raise ValueError(f"negative patch count {k} at level {l}")
        ptrs[l], Hs[l], Ws[l], first[l] = img.data_ptr(), H, W, start
        start += k
    lib = build.library()
    out = torch.empty((K, P, P), dtype=torch.float32, device=dev)
    args = (ptrs, Hs, Ws, first, n, y0.data_ptr(), x0.data_ptr(), K, P, out.data_ptr(), build.stream_handle(y0))
    if index == torch.cuda.current_device():
        lib.call("ssvo_extract_patches_levels", *args)
    else:
        with torch.cuda.device(dev):
            lib.call("ssvo_extract_patches_levels", *args)
    extract_patches_levels.launches += 1
    return out


extract_patches_levels.launches = 0


def extract_patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) float32 image, (K,) int32 top-left origins (pre-clamped into
    the image) -> (K, P, P) float32 patches: the one-level case of
    ``extract_patches_levels``, whose launch count it adds to."""
    return extract_patches_levels([img], y0, x0, [y0.shape[0]], r)
