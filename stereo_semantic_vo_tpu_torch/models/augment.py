"""Detection training-data augmentation (darknet data.c semantics).

The port's own copy of ``stereo_semantic_vo_tpu.models.augment`` (numpy
only, unchanged): the same ``RandomState`` gives bit-equal output.

The training loader's augmentation: the detection pipeline's transforms
with the reference's exact parameter semantics (host-side numpy — the role
darknet's loader threads play, feeding device-resident training steps):

* **jitter crop** (`load_data_detection` /
  `Thirdparty/darknet/src/data.c:928-946`): four
  independent crop offsets uniform in ±w·jitter / ±h·jitter, the crop
  resized back to the input size;
* **horizontal flip** with probability 1/2 (`data.c:126-127`);
* **photometric distortion** (`random_distort_image`,
  `src/image.c:1330-1337`): hue shift uniform in ±hue (wrapping),
  saturation and exposure scaled by `rand_scale(s)` — uniform in [1, s]
  or its reciprocal with equal probability;
* **truth correction** (`correct_boxes`, `data.c:184-215`): boxes follow
  the crop/scale/flip, are clamped to [0, 1], and collapse to invalid
  when their area vanishes.

Grayscale-fed callers (the VO replay world) get the exposure part of the
distortion only — hue/saturation need chroma.
"""

from __future__ import annotations

import numpy as np


def rand_scale(rng: np.random.RandomState, s: float) -> float:
    """darknet rand_scale (utils.c): uniform in [1, s], reciprocal half
    the time."""
    v = rng.uniform(1.0, max(s, 1.0))
    return v if rng.randint(2) else 1.0 / v


def distort_hsv(img: np.ndarray, rng: np.random.RandomState,
                hue: float, saturation: float, exposure: float) -> np.ndarray:
    """random_distort_image on (H, W, 3) float32 in [0, 1] (RGB)."""
    dhue = rng.uniform(-hue, hue)
    dsat = rand_scale(rng, saturation)
    dexp = rand_scale(rng, exposure)
    mx = img.max(axis=-1)
    mn = img.min(axis=-1)
    v = mx
    c = mx - mn
    s = np.where(mx > 1e-6, c / np.maximum(mx, 1e-6), 0.0)
    # hue in [0, 1) (darknet scales H to sixths of the hex cone)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    h = np.zeros_like(v)
    safe_c = np.maximum(c, 1e-6)
    h = np.where(mx == r, (g - b) / safe_c % 6.0, h)
    h = np.where(mx == g, (b - r) / safe_c + 2.0, h)
    h = np.where(mx == b, (r - g) / safe_c + 4.0, h)
    h = (h / 6.0) % 1.0
    h = (h + dhue) % 1.0
    s = np.clip(s * dsat, 0.0, 1.0)
    v = np.clip(v * dexp, 0.0, 1.0)
    # HSV -> RGB
    h6 = h * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    f = h6 - np.floor(h6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    out = np.empty_like(img)
    for k, (rr, gg, bb) in enumerate(
        [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    ):
        m = i == k
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out


def augment_detection(
    img: np.ndarray,
    boxes_rel: np.ndarray,
    boxes_mask: np.ndarray,
    rng: np.random.RandomState,
    jitter: float = 0.3,
    hue: float = 0.1,
    saturation: float = 1.5,
    exposure: float = 1.5,
    flip: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One darknet-style augmentation draw.

    img: (H, W, 3) float32 [0, 1]; boxes_rel: (T, 5) relative cxcywh+class
    (region/yolo truth layout, models/yolo_train); boxes_mask: (T,) bool.
    Returns (augmented image at the same size, transformed truths, mask).
    """
    H, W, _ = img.shape
    dw, dh = W * jitter, H * jitter
    pleft = rng.uniform(-dw, dw)
    ptop = rng.uniform(-dh, dh)
    pright = rng.uniform(-dw, dw)
    pbot = rng.uniform(-dh, dh)
    swidth = W - pleft - pright
    sheight = H - ptop - pbot
    sx = swidth / W
    sy = sheight / H
    do_flip = bool(flip and rng.randint(2))

    # crop_image with out-of-bounds regions filled by edge clamp (darknet
    # crop_image clamps source coords), then resize back to (H, W)
    ys = np.clip(
        np.round(ptop + np.arange(H) * sheight / H).astype(np.int64), 0, H - 1
    )
    xs = np.clip(
        np.round(pleft + np.arange(W) * swidth / W).astype(np.int64), 0, W - 1
    )
    out = img[ys][:, xs]
    if do_flip:
        out = out[:, ::-1]
    out = distort_hsv(out, rng, hue, saturation, exposure)

    # correct_boxes: left' = left*(1/sx) - (pleft/W)/sx, etc.
    t = boxes_rel.copy()
    m = boxes_mask.copy()
    dx = (pleft / W) / sx
    dy = (ptop / H) / sy
    cx, cy, w, h = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    left = (cx - w / 2) / sx - dx
    right = (cx + w / 2) / sx - dx
    top = (cy - h / 2) / sy - dy
    bot = (cy + h / 2) / sy - dy
    if do_flip:
        left, right = 1.0 - right, 1.0 - left
    left, right = np.clip(left, 0, 1), np.clip(right, 0, 1)
    top, bot = np.clip(top, 0, 1), np.clip(bot, 0, 1)
    t[:, 0] = (left + right) / 2
    t[:, 1] = (top + bot) / 2
    t[:, 2] = right - left
    t[:, 3] = bot - top
    m = m & (t[:, 2] > 0.002) & (t[:, 3] > 0.002)
    return out.astype(np.float32), t, m


def augment_batch(images, truths, masks, rng, **kw):
    """Vectorized convenience: applies an independent draw per sample."""
    out_i, out_t, out_m = [], [], []
    for i in range(len(images)):
        a, t, m = augment_detection(images[i], truths[i], masks[i], rng, **kw)
        out_i.append(a)
        out_t.append(t)
        out_m.append(m)
    return np.stack(out_i), np.stack(out_t), np.stack(out_m)
