"""KITTI odometry sequence loading + offline detection boxes.

Mirrors the reference's dataset plumbing (main.cpp:20-57 LoadImages: times.txt
plus image_2/ image_3 six-digit PNG names; main.cpp:59-97 Loadboundingbox:
whitespace-separated int rows ``left right top bottom`` per detection, one
file per frame named ``<frame+1>.txt``) — but returns numpy arrays and fixed-
shape padded box arrays for the tracker.

Copied from ``stereo_semantic_vo_tpu.io.kitti``.  Decoding happens on the
host: with the native C++ prefetcher (io/native_loader.py) where it builds,
else with Pillow; the pipeline's prefetch thread overlaps either with device
compute.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np


class SequencePaths(NamedTuple):
    left: list[str]
    right: list[str]
    timestamps: np.ndarray


def load_sequence_paths(seq_dir: str) -> SequencePaths:
    """KITTI layout: <seq>/times.txt, <seq>/image_2/NNNNNN.png (left color),
    <seq>/image_3/NNNNNN.png (right color). (main.cpp:20-57)"""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64)
    times = np.atleast_1d(times)
    n = len(times)
    left = [os.path.join(seq_dir, "image_2", f"{i:06d}.png") for i in range(n)]
    right = [os.path.join(seq_dir, "image_3", f"{i:06d}.png") for i in range(n)]
    return SequencePaths(left=left, right=right, timestamps=times)


def load_image_gray(path: str) -> np.ndarray:
    """Decode an image to (H, W) float32 grayscale in [0, 255]."""
    from PIL import Image

    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.float32)


def load_offline_boxes(
    path: str, max_boxes: int, img_w: int | None = None, img_h: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Parse one offline YOLO box file (rows of ints: left right top bottom,
    main.cpp:76-96 + Tracking.cc:55-66) into a fixed-shape
    ((max_boxes, 4) [x1, y1, x2, y2] float32, (max_boxes,) bool) pair.
    Missing file -> empty boxes (the reference exit(233)s; we degrade)."""
    boxes = np.zeros((max_boxes, 4), np.float32)
    valid = np.zeros(max_boxes, bool)
    if not os.path.exists(path):
        return boxes, valid
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) >= 4:
                l, r, t, b = (float(v) for v in vals[:4])
                rows.append((l, t, r, b))
    for i, row in enumerate(rows[:max_boxes]):
        boxes[i] = row
        valid[i] = True
    return boxes, valid


def iter_frames(
    paths: SequencePaths,
    boxes_dir: str | None,
    max_boxes: int,
    max_frames: int | None = None,
    use_native: bool = True,
    image_hw: tuple[int, int] | None = None,
) -> Iterator[tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]]:
    """Yield (idx, left, right, boxes, boxes_valid, timestamp) per frame.

    When the native C++ prefetcher is buildable (and ``image_hw`` gives the
    fixed frame size), decode runs ahead on a thread pool; otherwise falls
    back to per-frame Pillow decode."""
    n = len(paths.left)
    if max_frames is not None:
        n = min(n, max_frames)

    native_iter = None
    if use_native and image_hw is not None:
        from stereo_semantic_vo_tpu_torch.io import native_loader

        if native_loader.available():
            native_iter = iter(
                native_loader.NativeFrameLoader(
                    paths.left[:n], paths.right[:n], image_hw[0], image_hw[1]
                )
            )

    for i in range(n):
        if native_iter is not None:
            left, right = next(native_iter)
        else:
            left = load_image_gray(paths.left[i])
            right = load_image_gray(paths.right[i])
        if boxes_dir is not None:
            # reference names files 1-based: bin/offline/0.05results/<n+1>.txt
            bpath = os.path.join(boxes_dir, f"{i + 1}.txt")
            boxes, valid = load_offline_boxes(bpath, max_boxes)
        else:
            boxes = np.zeros((max_boxes, 4), np.float32)
            valid = np.zeros(max_boxes, bool)
        yield i, left, right, boxes, valid, float(paths.timestamps[i])
