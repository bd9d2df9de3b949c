"""YOLO detector family as a cfg-driven PyTorch CNN.

Port of ``stereo_semantic_vo_tpu.models.yolo``: conv-BN(folded)-leaky
blocks, maxpool, route, shortcut and upsample layers, region (YOLOv2) and
yolo (YOLOv3) heads, letterboxing and fixed-shape greedy NMS (darknet's
do_nms_sort semantics).  The network runs NCHW in float32; the convolutions
are ``F.conv2d`` (cuDNN on a card), the counterpart of the XLA convolutions
of the JAX package, with TF32 off (``core/precision.f32_matmul``).

Three details keep it equal to the JAX package:

- JAX's ``"SAME"`` padding pads ``total = max((out - 1) * s + k - in, 0)``
  with ``total // 2`` low and the rest high: (1, 1) for a stride-1 3x3
  conv, (0, 1) for a stride-2 3x3 conv on an even input, nothing for 1x1.
- ``letterbox`` resizes with antialiasing, as ``jax.image.resize`` does
  when it shrinks.
- ``decode_head`` permutes the NCHW map to NHWC before it splits the
  channels per anchor, so the flat box order, and with it NMS and the class
  lookup, is JAX's.

Nothing here reads a device value back to the host: ``detect`` can be
queued on a side stream while the tracking step runs (engine/pipeline.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stereo_semantic_vo_tpu_torch.core.precision import f32_matmul
from stereo_semantic_vo_tpu_torch.io import darknet

LEAKY_SLOPE = 0.1


class Detections(NamedTuple):
    boxes: torch.Tensor    # (N, 4) [x1, y1, x2, y2] in original-image pixels
    scores: torch.Tensor   # (N,)
    classes: torch.Tensor  # (N,) int32
    valid: torch.Tensor    # (N,) bool


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of one spatial dim under XLA's "SAME"."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    k = w.shape[-1]
    (hl, hh), (wl, wh) = _same_pads(x.shape[2], k, stride), _same_pads(x.shape[3], k, stride)
    if hl == hh and wl == wh:
        return F.conv2d(x, w, b, stride, (hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, b, stride)


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    if size == 2 and stride == 1:
        # darknet pads right/bottom to keep the spatial size
        x = F.pad(x, (0, 1, 0, 1), value=-float("inf"))
    return F.max_pool2d(x, size, stride)


def head_anchors(sec: dict) -> np.ndarray:
    """(n_anchor, 2) float32 anchors of a region or yolo head: grid cells for
    region, input pixels (selected by ``mask``) for yolo."""
    anchors = np.asarray(sec.get("anchors", ()), np.float32).reshape(-1, 2)
    if sec["type"] == "region":
        return anchors[: int(sec.get("num", 5))]
    mask = sec.get("mask", (0, 1, 2))
    return anchors[list(mask if isinstance(mask, tuple) else (mask,))]


class YoloNet(nn.Module):
    """The cfg graph with folded params ``{layer: {"w": HWIO, "b": (n,)}}``
    (io/darknet.py).  The weights become OIHW buffers once, here.

    ``forward(x)`` takes (B, 3, H, W) in [0, 1] and returns
    ``[(head_section, feature_map (B, C, h, w)), ...]`` for every region or
    yolo head.  ``anchors[i]`` is head i's (n_anchor, 2) anchor tensor, on
    the module's device, for ``decode_head``.
    """

    def __init__(self, sections: list[dict[str, Any]], params: dict[int, dict[str, np.ndarray]]):
        super().__init__()
        self.sections = sections
        n_heads = 0
        for li, sec in enumerate(sections[1:]):
            if sec["type"] == "convolutional":
                w = np.ascontiguousarray(np.transpose(np.asarray(params[li]["w"], np.float32), (3, 2, 0, 1)))
                self.register_buffer(f"w{li}", torch.from_numpy(w))
                self.register_buffer(f"b{li}", torch.from_numpy(np.asarray(params[li]["b"], np.float32).copy()))
            elif sec["type"] in ("region", "yolo"):
                self.register_buffer(f"anchors{n_heads}", torch.from_numpy(head_anchors(sec)))
                n_heads += 1
        self.n_heads = n_heads

    @property
    def anchors(self) -> list[torch.Tensor]:
        return [getattr(self, f"anchors{i}") for i in range(self.n_heads)]

    def forward(self, x: torch.Tensor) -> list[tuple[dict, torch.Tensor]]:
        outputs: list[torch.Tensor] = []
        heads: list[tuple[dict, torch.Tensor]] = []
        for li, sec in enumerate(self.sections[1:]):
            t = sec["type"]
            if t == "convolutional":
                x = _conv_same(x, getattr(self, f"w{li}"), getattr(self, f"b{li}"), int(sec.get("stride", 1)))
                if sec.get("activation", "linear") == "leaky":
                    x = F.leaky_relu(x, LEAKY_SLOPE)
            elif t == "maxpool":
                x = _maxpool(x, int(sec.get("size", 2)), int(sec.get("stride", 2)))
            elif t == "route":
                layers = sec.get("layers", ())
                if not isinstance(layers, tuple):
                    layers = (layers,)
                x = torch.cat([outputs[i if i >= 0 else li + i] for i in layers], dim=1)
            elif t == "shortcut":
                frm = int(sec["from"])
                x = x + outputs[frm if frm >= 0 else li + frm]
                if sec.get("activation", "linear") == "leaky":
                    x = F.leaky_relu(x, LEAKY_SLOPE)
            elif t == "upsample":
                x = F.interpolate(x, scale_factor=int(sec.get("stride", 2)), mode="nearest")
            elif t in ("region", "yolo"):
                heads.append((sec, x))
            outputs.append(x)
        return heads


def forward(
    params: dict[int, dict[str, np.ndarray]], sections: list[dict[str, Any]], x: torch.Tensor
) -> list[tuple[dict, torch.Tensor]]:
    """The JAX package's functional ``forward`` on (B, 3, H, W) input:
    ``[(head_section, feature_map NCHW), ...]``."""
    with torch.no_grad(), f32_matmul():
        return YoloNet(sections, params).to(x.device)(x)


def decode_head(
    sec: dict, feat: torch.Tensor, num_classes: int, anchors: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one region/yolo head (``feat`` NCHW) -> (boxes_rel (B, N, 4)
    cx, cy, w, h in [0, 1] of the network input, class scores (B, N, nc),
    objectness (B, N)), N = h * w * n_anchor in JAX's NHWC order.

    region (v2): anchors in grid cells, softmax classes when ``softmax=1``
    (region_layer.c:76-83).  yolo (v3): anchors in input pixels, divided by
    the net size, sigmoid classes.  ``anchors`` is ``head_anchors(sec)`` as a
    tensor on ``feat``'s device (``YoloNet.anchors`` holds them there, so
    that decoding copies nothing to the device).
    """
    B, C, H, W = feat.shape
    is_region = sec["type"] == "region"
    n_anchor, nc = anchors.shape[0], num_classes
    f = feat.permute(0, 2, 3, 1).reshape(B, H, W, n_anchor, 5 + nc)
    tx, ty, tw, th, tobj = f[..., 0], f[..., 1], f[..., 2], f[..., 3], f[..., 4]
    tcls = f[..., 5:]
    gx = torch.arange(W, dtype=torch.float32, device=feat.device)[None, None, :, None]
    gy = torch.arange(H, dtype=torch.float32, device=feat.device)[None, :, None, None]
    bx = (gx + torch.sigmoid(tx)) / W
    by = (gy + torch.sigmoid(ty)) / H
    aw, ah = anchors[:, 0], anchors[:, 1]
    if is_region:
        bw = torch.exp(tw) * aw / W
        bh = torch.exp(th) * ah / H
    else:
        bw = torch.exp(tw) * aw / float(sec.get("_net_w", 416))
        bh = torch.exp(th) * ah / float(sec.get("_net_h", 416))
    obj = torch.sigmoid(tobj)
    if is_region and int(sec.get("softmax", 0)) == 1:
        cls = torch.softmax(tcls, dim=-1)
    else:
        cls = torch.sigmoid(tcls)
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(B, -1, 4)
    return boxes, cls.reshape(B, -1, nc), obj.reshape(B, -1)


def iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU for [x1, y1, x2, y2]
    boxes (leading axes broadcast)."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_fixed(
    boxes: torch.Tensor, scores: torch.Tensor, max_out: int, iou_th: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS with static shapes: ``max_out`` steps, each picking the
    highest live score (the first on ties) and suppressing overlaps above
    ``iou_th`` (box.c:58 do_nms_sort).  A step whose best score is 0 keeps
    that box with ``valid=False`` and suppresses nothing.  Returns (boxes
    (max_out, 4), scores (max_out,), valid (max_out,)): :func:`nms_fixed_batch`
    of a batch of one."""
    b, s, v = nms_fixed_batch(boxes[None], scores[None], max_out, iou_th)
    return b[0], s[0], v[0]


def nms_fixed_batch(
    boxes: torch.Tensor, scores: torch.Tensor, max_out: int, iou_th: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`nms_fixed` of each image of a batch in one program: (B, N, 4)
    boxes and (B, N) scores -> (B, max_out, 4), (B, max_out), (B, max_out).
    Each step picks every image's highest live score (the first on ties) by
    one ``argmax`` over the batch.

    The picks are (B, 1) index tensors used through ``gather``: indexing
    with a device tensor would read it back to the host."""
    B, N = scores.shape
    iou = iou_xyxy(boxes, boxes)
    idx = torch.arange(N, device=boxes.device)
    alive = scores
    out_b, out_s, out_v = [], [], []
    for _ in range(max_out):
        i = torch.argmax(alive, dim=1, keepdim=True)  # (B, 1)
        s = alive.gather(1, i)
        keep = s > 0.0
        suppress = iou.gather(1, i[:, :, None].expand(B, 1, N))[:, 0] > iou_th
        new = torch.where(suppress | (idx == i), 0.0, alive)
        alive = torch.where(keep, new, alive)
        out_b.append(boxes.gather(1, i[:, :, None].expand(B, 1, 4)))
        out_s.append(s)
        out_v.append(keep)
    return torch.cat(out_b, 1), torch.cat(out_s, 1), torch.cat(out_v, 1)


def letterbox(img: torch.Tensor, net_w: int, net_h: int, img_w: int, img_h: int) -> torch.Tensor:
    """(H, W, 3) [0, 1] -> (net_h, net_w, 3), aspect-preserving, 0.5-padded
    (darknet letterbox_image, image.c)."""
    return letterbox_batch(img[None], net_w, net_h, img_w, img_h)[0]


def letterbox_batch(imgs: torch.Tensor, net_w: int, net_h: int, img_w: int, img_h: int) -> torch.Tensor:
    """:func:`letterbox` of each of (B, H, W, 3) images -> (B, net_h, net_w, 3)."""
    scale = min(net_w / img_w, net_h / img_h)
    new_w = int(img_w * scale)
    new_h = int(img_h * scale)
    resized = F.interpolate(imgs.permute(0, 3, 1, 2), size=(new_h, new_w), mode="bilinear",
                            align_corners=False, antialias=True)
    out = torch.full((imgs.shape[0], 3, net_h, net_w), 0.5, dtype=imgs.dtype, device=imgs.device)
    oy = (net_h - new_h) // 2
    ox = (net_w - new_w) // 2
    out[:, :, oy:oy + new_h, ox:ox + new_w] = resized
    return out.permute(0, 2, 3, 1)


def unletterbox_boxes(boxes_rel: torch.Tensor, net_w: int, net_h: int, img_w: int, img_h: int) -> torch.Tensor:
    """(..., N, 4) cx, cy, w, h relative to the net input -> (..., N, 4)
    x1y1x2y2 image px."""
    scale = min(net_w / img_w, net_h / img_h)
    ox = (net_w - img_w * scale) / 2.0
    oy = (net_h - img_h * scale) / 2.0
    cx = (boxes_rel[..., 0] * net_w - ox) / scale
    cy = (boxes_rel[..., 1] * net_h - oy) / scale
    w = boxes_rel[..., 2] * net_w / scale
    h = boxes_rel[..., 3] * net_h / scale
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


class YoloDetector:
    """cfg + weights -> ``detect(image) -> Detections`` on one device.

    The port of the reference's Semantic thread (src/semantic.cc): detection
    is a call that queues device work and returns device tensors; the
    pipeline runs it on a side CUDA stream, one frame ahead of its use.
    ``device`` defaults to the card; pass ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        cfg_text: str,
        weights_bytes: bytes | None = None,
        conf_threshold: float = 0.8,
        nms_iou: float = 0.45,
        max_boxes: int = 32,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        sections = darknet.parse_cfg(cfg_text)
        if weights_bytes is not None:
            params = darknet.load_weights(sections, weights_bytes)
        else:
            params = darknet.random_weights(sections, seed)
        self._setup(sections, params, conf_threshold, nms_iou, max_boxes, device)

    @classmethod
    def from_params(
        cls,
        cfg_text: str,
        params: dict[int, dict[str, np.ndarray]],
        conf_threshold: float = 0.8,
        nms_iou: float = 0.45,
        max_boxes: int = 32,
        device: torch.device | str = "cuda",
    ) -> YoloDetector:
        """A detector on folded numpy params, e.g. the JAX detector's
        ``params``, so that both packages run the same weights."""
        self = cls.__new__(cls)
        self._setup(darknet.parse_cfg(cfg_text), params, conf_threshold, nms_iou, max_boxes, device)
        return self

    def _setup(self, sections, params, conf_threshold, nms_iou, max_boxes, device) -> None:
        self.sections = sections
        net = sections[0]
        self.net_w = int(net.get("width", 416))
        self.net_h = int(net.get("height", 416))
        for sec in sections:
            if sec["type"] in ("region", "yolo"):
                sec["_net_w"] = self.net_w
                sec["_net_h"] = self.net_h
                self.num_classes = int(sec.get("classes", 1))
        self.params = params
        self.conf_threshold = conf_threshold
        self.nms_iou = nms_iou
        self.max_boxes = max_boxes
        self.net = YoloNet(sections, params).to(torch.device(device))

    @property
    def device(self) -> torch.device:
        """The device the weights are on (with its index on a card)."""
        return self.net.anchors[0].device

    def heads(self, img: torch.Tensor) -> list[tuple[dict, torch.Tensor]]:
        """The network's head maps (NCHW) on the letterboxed image (H, W, 3) or
        (H, W) in [0, 1]."""
        if img.dim() == 2:
            img = torch.stack([img, img, img], dim=-1)
        x = letterbox(img, self.net_w, self.net_h, img.shape[1], img.shape[0]).permute(2, 0, 1)[None]
        with torch.no_grad(), f32_matmul():
            return self.net(x.contiguous())

    def candidates(
        self, heads: list[tuple[dict, torch.Tensor]], img_w: int, img_h: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The head maps of a batch of (img_h, img_w) images -> each image's
        candidate boxes before NMS: (B, N, 4) x1y1x2y2 image px, (B, N)
        scores (0 below ``conf_threshold``) and (B, N) classes."""
        all_boxes, all_scores, all_cls = [], [], []
        for (sec, feat), anchors in zip(heads, self.net.anchors):
            boxes, cls, obj = decode_head(sec, feat, self.num_classes, anchors)
            score = obj[..., None] * cls
            all_boxes.append(boxes)
            all_scores.append(torch.amax(score, dim=-1))
            all_cls.append(torch.argmax(score, dim=-1))
        scores = torch.cat(all_scores, dim=1)
        scores = torch.where(scores >= self.conf_threshold, scores, 0.0)
        boxes_px = unletterbox_boxes(torch.cat(all_boxes, dim=1), self.net_w, self.net_h, img_w, img_h)
        return boxes_px, scores, torch.cat(all_cls, dim=1)

    def detect(self, img: torch.Tensor) -> Detections:
        """img: (H, W, 3) or (H, W) float32 in [0, 1], on the detector's device."""
        with torch.no_grad():
            boxes, scores, classes = (x[0] for x in self.candidates(self.heads(img), img.shape[1], img.shape[0]))
            b, s, v = nms_fixed(boxes, scores, self.max_boxes, self.nms_iou)
            cls_out = classes.gather(0, torch.argmax(iou_xyxy(b, boxes), dim=1)).to(torch.int32)
        return Detections(boxes=b, scores=s, classes=cls_out, valid=v)
