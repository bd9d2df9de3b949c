"""The benchmark's stereo scene: two textured fronto-parallel planes and a
moving object, with exact ground truth, made on the host from a seed.

The two-plane construction: the top half of the image is a plane at
disparity ``d_far`` px, the bottom half one at ``d_near`` px.  At frame t
the camera has moved right so that the planes shift by ``shift_far * t``
and ``shift_near * t`` px (``shift / d`` equal on both planes), a camera x
of ``t * shift_far * bf / (d_far * fx)`` metres with no rotation.  Every
frame is an exact integer-pixel shift of a uniform random texture: no
resampling error.

The world repeats every ``period_frames`` frames: each plane's texture is
``shift * period_frames`` columns wide and wraps, wider than the image
with its disparity, so no two columns of one frame repeat and the shift
from frame t to t+1 stays exact across the wrap.  A scene has no last
frame.

The mover is a ``size_px`` square of its own random texture at the far
plane's disparity, ``vy_px`` px lower each frame (off the horizontal
epipolar lines of the sideways-moving camera), under a box ``margin_px``
outside it.  When it has left the image, or the world's period ends, it
re-enters at ``y0`` with a fresh texture.  Its box is missed on frames
``u % miss_every == 0`` (u the frame's place in the period), as a late
detector misses: map points are created on the object then, and the
epipolar test has them to cull in the frames that follow.

Stream ``b`` of a seed has textures of its own and starts at frame
``stream_offset_frames * b`` of its world.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Frame(NamedTuple):
    t: int                  # frame index in the stream
    left: np.ndarray        # (H, W) float32 in [0, 255]
    right: np.ndarray
    boxes: np.ndarray       # (n_boxes, 4) float32 [x1, y1, x2, y2]
    boxes_valid: np.ndarray  # (n_boxes,) bool
    timestamp: float


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and ``keys``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *keys]))


def _texture(gen: np.random.Generator, shape) -> np.ndarray:
    return gen.random(shape, dtype=np.float32) * np.float32(255.0)


class Scene:
    """One stream's frames: ``frame(t)`` for any t >= 0."""

    def __init__(self, params: dict, seed: int, stream: int, height: int, width: int, fps: float,
                 n_boxes: int):
        self.p, self.seed, self.stream = params, int(seed), stream
        self.H, self.W, self.fps, self.n_boxes = height, width, fps, n_boxes
        self.period = int(params["period_frames"])
        self.offset = int(params["stream_offset_frames"]) * stream
        half = height // 2
        self.planes = []  # (rows, texture, shift, disparity)
        for k, (rows, shift, d) in enumerate(((slice(0, half), params["shift_far"], params["d_far"]),
                                              (slice(half, height), params["shift_near"], params["d_near"]))):
            cols = shift * self.period
            if cols < width + d:
                raise ValueError(f"a texture of {cols} columns repeats inside a {width} px frame")
            self.planes.append((rows, _texture(rng(seed, stream, 0, k), (rows.stop - rows.start, cols)), shift, d))
        m = params["mover"]
        self.pass_frames = max(1, math.ceil((height - m["y0"]) / m["vy_px"]))

    @staticmethod
    def _cols(tex: np.ndarray, start: int, n: int) -> np.ndarray:
        """``n`` columns of ``tex`` from ``start``, wrapping."""
        period = tex.shape[1]
        start %= period
        if start + n <= period:
            return tex[:, start:start + n]
        return np.concatenate([tex[:, start:], tex[:, :start + n - period]], axis=1)

    def mover_texture(self, k: int) -> np.ndarray:
        """The mover's texture on its k-th pass through the image."""
        s = self.p["mover"]["size_px"]
        return _texture(rng(self.seed, self.stream, 1, k), (s, s))

    def place(self, t: int) -> int:
        """Frame t's place in the world's period."""
        return (t + self.offset) % self.period

    @property
    def miss_every(self) -> int:
        return int(self.p["mover"]["miss_every"])

    def miss_phase(self, t: int) -> int:
        """Frame t's place in the mover's miss cycle: 0 where its box is
        missed, 1 on the frame after, and so on."""
        return self.place(t) % self.miss_every

    def frame(self, t: int, out: tuple[np.ndarray, np.ndarray] | None = None) -> Frame:
        """Frame t; its images are written into ``out`` (two (H, W)
        float32 arrays) where given, which saves the host an allocation."""
        H, W, u = self.H, self.W, self.place(t)
        left, right = out if out is not None else (np.empty((H, W), np.float32), np.empty((H, W), np.float32))
        for rows, tex, shift, d in self.planes:
            left[rows] = self._cols(tex, shift * u, W)
            right[rows] = self._cols(tex, shift * u + d, W)
        m = self.p["mover"]
        size, x, d_far = m["size_px"], m["x"], self.p["d_far"]
        k, i = divmod(u, self.pass_frames)
        y = m["y0"] + m["vy_px"] * i
        rows = min(size, H - y)
        obj = self.mover_texture(k)[:rows]
        left[y:y + rows, x:x + size] = obj
        right[y:y + rows, x - d_far:x - d_far + size] = obj
        boxes = np.zeros((self.n_boxes, 4), np.float32)
        valid = np.zeros(self.n_boxes, bool)
        g = m["margin_px"]
        boxes[0] = [x - g, y - g, x + size + g, y + size + g]
        valid[0] = self.miss_phase(t) != 0
        return Frame(t, left, right, boxes, valid, t / self.fps)

    def camera_x(self, t: int, bf: float, fx: float) -> float:
        """Ground-truth camera x (metres) at stream frame t, relative to
        the stream's first frame."""
        return t * self.p["shift_far"] * bf / (self.p["d_far"] * fx)


class Frames:
    """Each loop iteration's frames, one a stream, made on the host in the
    loop's own thread into buffers that it reuses: ~4 MB of copies a
    frame, in the shadow of the device's work on the frame before, and no
    thread of the benchmark competes with the program for the host."""

    def __init__(self, scenes: list[Scene]):
        self.scenes = scenes
        self.buffers = [(np.empty((s.H, s.W), np.float32), np.empty((s.H, s.W), np.float32)) for s in scenes]

    def get(self, t: int, out: list | None = None) -> list[Frame]:
        """Frame t of every stream, in ``out`` (a pair of arrays a stream)
        or in this object's buffers, which the next call overwrites."""
        return [s.frame(t, o) for s, o in zip(self.scenes, out or self.buffers)]
