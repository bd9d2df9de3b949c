"""A plain darknet detector: the benchmark's reference for the port's online
YOLO (tiny YOLOv2's region head and YOLOv3's yolo heads).

Written from darknet's description (pjreddie/darknet): the cfg as
``parser.c`` reads it, the ``.weights`` file as ``load_weights`` reads it
(a header, then for each convolution in cfg order its biases, for a
batch-normalized one its scales, rolling means and rolling variances, then
its OIHW weights), batch norm folded as ``normalize_cpu`` computes it
(``(x - mean) / (sqrt(var) + 1e-6)``, ``blas.c:154``), and the forward pass
of ``convolutional_layer.c`` (im2col and one matrix product, as darknet's
CPU path), ``maxpool_layer.c``, ``route_layer.c``, ``shortcut_layer.c``,
``upsample_layer.c``, ``region_layer.c`` and ``yolo_layer.c``, with greedy
NMS as ``box.c``'s ``do_nms_sort``.  Plain PyTorch in float32, TF32 off; a
batch of one image, layer outputs freed once no later layer reads them,
heads decoded one at a time.  It imports neither JAX, nor the JAX package,
nor anything of the port.

Where darknet leaves a choice open or the system departs from it, the
reference follows the system and says so here:

* Letterboxing: the image is shrunk by a triangle filter widened by the
  shrink factor (the antialiased linear resize of ``jax.image.resize``),
  not by darknet's ``resize_image`` (plain bilinear), and boxes are mapped
  back by the exact float scale, not by the integer size that
  ``correct_region_boxes`` uses.  The sizes and the offsets of the
  letterbox are darknet's integers.
* NMS is class-agnostic, on each candidate's best class score; with one
  class, as in the KITTI car detector, that is ``do_nms_sort`` exactly.
  Candidates are ordered cell by cell, then anchor by anchor; a tie of
  scores (which darknet's ``qsort`` leaves unordered) goes to the first.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vo_bench.reference.precision import f32_matmul, matmul_precision

HEADS = ("region", "yolo")


def parse_cfg(text: str) -> list[dict[str, str]]:
    """darknet's cfg text -> its sections in order, each ``{"type": name,
    key: raw value}`` (``parser.c`` ``read_cfg``: ``#`` and ``;`` start a
    comment line, spaces are dropped)."""
    sections: list[dict[str, str]] = []
    for raw in text.splitlines():
        line = raw.replace(" ", "").replace("\t", "")
        if not line or line[0] in "#;":
            continue
        if line[0] == "[":
            sections.append({"type": line[1:line.index("]")]})
        elif "=" in line and sections:
            key, value = line.split("=", 1)
            sections[-1][key] = value
    if not sections or sections[0]["type"] not in ("net", "network"):
        raise ValueError("a darknet cfg starts with [net]")
    return sections


def _int(sec: dict, key: str, default: int) -> int:
    return int(sec.get(key, default))


def _ints(sec: dict, key: str) -> list[int]:
    return [int(v) for v in sec[key].split(",") if v]


class Shape(NamedTuple):
    """One layer's output: channels, height, width."""

    c: int
    h: int
    w: int


class Conv(NamedTuple):
    index: int       # the layer's index (the [net] section excluded)
    n: int           # filters
    c: int           # input channels
    size: int
    stride: int
    pad: int         # pixels on every side: size / 2 where ``pad=1`` (parse_convolutional)
    bn: bool
    activation: str


def _conv(index: int, sec: dict, c: int) -> Conv:
    size = _int(sec, "size", 1)
    pad = size // 2 if _int(sec, "pad", 0) else _int(sec, "padding", 0)
    if _int(sec, "groups", 1) != 1 or _int(sec, "dilation", 1) != 1:
        raise ValueError(f"layer {index}: grouped or dilated convolutions are not darknet's yolov2/v3 set")
    return Conv(index, _int(sec, "filters", 1), c, size, _int(sec, "stride", 1), pad,
                _int(sec, "batch_normalize", 0) == 1, sec.get("activation", "logistic"))


def _maxpool(sec: dict) -> tuple[int, int, int]:
    """(size, stride, padding) as ``parse_maxpool`` reads them."""
    stride = _int(sec, "stride", 1)
    size = _int(sec, "size", stride)
    return size, stride, _int(sec, "padding", size - 1)


def _at(index: int, i: int) -> int:
    """A route's or shortcut's layer index: relative where negative."""
    return index + i if i < 0 else i


def walk(sections: list[dict]) -> tuple[list[Shape], list[Conv]]:
    """Every layer's output shape and every convolution, at the [net]
    section's input size (``parse_network_cfg``)."""
    net = sections[0]
    here = Shape(_int(net, "channels", 3), _int(net, "height", 0), _int(net, "width", 0))
    shapes: list[Shape] = []
    convs: list[Conv] = []
    for index, sec in enumerate(sections[1:]):
        kind = sec["type"]
        if kind in ("convolutional", "conv"):
            conv = _conv(index, sec, here.c)
            convs.append(conv)
            oh = (here.h + 2 * conv.pad - conv.size) // conv.stride + 1
            ow = (here.w + 2 * conv.pad - conv.size) // conv.stride + 1
            here = Shape(conv.n, oh, ow)
        elif kind in ("maxpool", "max"):
            size, stride, padding = _maxpool(sec)
            here = Shape(here.c, (here.h + padding - size) // stride + 1, (here.w + padding - size) // stride + 1)
        elif kind == "route":
            parts = [shapes[_at(index, i)] for i in _ints(sec, "layers")]
            if len({(p.h, p.w) for p in parts}) != 1:
                raise ValueError(f"layer {index}: a route of maps of different sizes")
            here = Shape(sum(p.c for p in parts), parts[0].h, parts[0].w)
        elif kind == "upsample":
            stride = _int(sec, "stride", 2)
            if stride < 1:
                raise ValueError(f"layer {index}: a downsampling [upsample] is not darknet's yolov3 set")
            here = Shape(here.c, here.h * stride, here.w * stride)
        elif kind == "shortcut":
            if shapes[_at(index, _int(sec, "from", 0))] != here:
                raise ValueError(f"layer {index}: a shortcut between maps of different shapes")
        elif kind not in HEADS:
            raise ValueError(f"layer {index}: [{kind}] is not in darknet's yolov2/v3 layer set")
        shapes.append(here)
    return shapes, convs


def read_weights(sections: list[dict], blob: bytes) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """A darknet ``.weights`` blob -> ``{layer index: (OIHW weights, bias)}``
    float32, batch norm folded in; the blob must hold exactly the cfg's
    convolutions."""
    major, minor, _ = np.frombuffer(blob, "<i4", 3)
    at = 12 + (8 if major * 10 + minor >= 2 and major < 1000 and minor < 1000 else 4)  # "seen"
    out = {}

    def take(count: int) -> np.ndarray:
        nonlocal at
        if at + 4 * count > len(blob):
            raise ValueError(f"the weights end {at + 4 * count - len(blob)} bytes short")
        a = np.frombuffer(blob, "<f4", count, at).astype(np.float32)
        at += 4 * count
        return a

    for conv in walk(sections)[1]:
        bias = take(conv.n)
        if conv.bn:
            scales, mean, var = take(conv.n), take(conv.n), take(conv.n)
        w = take(conv.n * conv.c * conv.size * conv.size).reshape(conv.n, conv.c, conv.size, conv.size)
        if conv.bn:
            k = scales / (np.sqrt(var) + np.float32(1e-6))
            w = w * k[:, None, None, None]
            bias = bias - mean * k
        out[conv.index] = (w, bias)
    if at != len(blob):
        raise ValueError(f"{len(blob) - at} bytes of the weights are left over")
    return out


def resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64 weights of a linear resize along one axis: a
    triangle filter on pixel centres, widened by the shrink factor where it
    shrinks, each row normalized to 1."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale
    x = (torch.arange(n_in, dtype=torch.float64)[None, :] + 0.5 - centre[:, None]) / width
    tri = torch.clamp(1.0 - x.abs(), min=0.0)
    return tri / tri.sum(dim=1, keepdim=True)


def letterbox_size(net_w: int, net_h: int, img_w: int, img_h: int) -> tuple[int, int]:
    """The shrunk image's (width, height) inside the net input
    (``letterbox_image``'s integers)."""
    if net_w / img_w < net_h / img_h:
        return net_w, (img_h * net_w) // img_w
    return (img_w * net_h) // img_h, net_h


def letterbox(gray: torch.Tensor, net_w: int, net_h: int) -> torch.Tensor:
    """(H, W) grey in [0, 1] -> (1, 3, net_h, net_w): the shrunk image on a
    0.5 canvas at darknet's offsets, its grey in all three channels."""
    img_h, img_w = gray.shape
    new_w, new_h = letterbox_size(net_w, net_h, img_w, img_h)
    rows = resize_matrix(img_h, new_h).to(gray.device, torch.float32)
    cols = resize_matrix(img_w, new_w).to(gray.device, torch.float32)
    out = torch.full((1, 3, net_h, net_w), 0.5, dtype=torch.float32, device=gray.device)
    oy, ox = (net_h - new_h) // 2, (net_w - new_w) // 2
    out[0, :, oy:oy + new_h, ox:ox + new_w] = rows @ gray @ cols.T
    return out


def _activate(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "linear":
        return x
    if name == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if name == "logistic":
        return 1.0 / (1.0 + torch.exp(-x))
    if name == "relu":
        return torch.clamp(x, min=0.0)
    raise ValueError(f"activation {name!r} is not in darknet's yolov2/v3 set")


@contextlib.contextmanager
def arithmetic(tf32: bool):
    """float32 with TF32 off; with ``tf32`` (the control) every product's
    operands rounded to TF32, and a card's TF32 switched on as well."""
    with matmul_precision(tf32), f32_matmul():
        if tf32:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        yield


class Detections(NamedTuple):
    heads: list[torch.Tensor]  # each head's input map (1, C, h, w), as the last convolution wrote it
    boxes: np.ndarray          # (max_boxes, 4) float32 [x1, y1, x2, y2] image px
    valid: np.ndarray          # (max_boxes,) bool
    edge: np.ndarray           # (max_boxes,) bool: a kept slot whose box rounding could drop (``Detector.nms``)
    optional: np.ndarray       # (M, 4) float32: every candidate that rounding could keep or drop


class Detector:
    """A darknet cfg and ``.weights`` blob -> ``detect(gray)``."""

    def __init__(self, cfg_text: str, blob: bytes, conf_threshold: float, nms_iou: float, max_boxes: int,
                 device: torch.device):
        self.sections = parse_cfg(cfg_text)
        net = self.sections[0]
        self.net_w, self.net_h = _int(net, "width", 0), _int(net, "height", 0)
        self.shapes, convs = walk(self.sections)
        self.convs = {cv.index: cv for cv in convs}
        self.params = {i: (torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
                       for i, (w, b) in read_weights(self.sections, blob).items()}
        self.conf, self.nms_iou, self.max_boxes = conf_threshold, nms_iou, max_boxes
        # the last layer that reads each output, so that it is freed after
        self.last_use: dict[int, int] = {}
        for index, sec in enumerate(self.sections[1:]):
            reads = [index - 1] if index else []
            if sec["type"] == "route":
                reads = [_at(index, i) for i in _ints(sec, "layers")]
            elif sec["type"] == "shortcut":
                reads.append(_at(index, _int(sec, "from", 0)))
            for r in reads:
                self.last_use[r] = index

    def _convolve(self, x: torch.Tensor, conv: Conv) -> torch.Tensor:
        w, b = self.params[conv.index]
        oh, ow = self.shapes[conv.index].h, self.shapes[conv.index].w
        cols = F.unfold(x, conv.size, padding=conv.pad, stride=conv.stride)   # (1, c k k, oh ow): im2col
        y = (w.reshape(conv.n, -1) @ cols[0]).reshape(1, conv.n, oh, ow) + b[None, :, None, None]
        return _activate(y, conv.activation)

    def forward(self, x: torch.Tensor) -> list[tuple[dict, torch.Tensor]]:
        """The letterboxed input -> ``[(head section, head input map)]``."""
        outputs: dict[int, torch.Tensor] = {}
        heads = []
        for index, sec in enumerate(self.sections[1:]):
            kind = sec["type"]
            if kind in ("convolutional", "conv"):
                x = self._convolve(x, self.convs[index])
            elif kind in ("maxpool", "max"):
                size, stride, padding = _maxpool(sec)
                left = padding // 2
                s = self.shapes[index]
                right_h = (s.h - 1) * stride + size - x.shape[2] - left
                right_w = (s.w - 1) * stride + size - x.shape[3] - left
                x = F.pad(x, (left, max(right_w, 0), left, max(right_h, 0)), value=-math.inf)
                x = F.max_pool2d(x, size, stride)[:, :, :s.h, :s.w]
            elif kind == "route":
                x = torch.cat([outputs[_at(index, i)] for i in _ints(sec, "layers")], dim=1)
            elif kind == "shortcut":
                x = _activate(x + outputs[_at(index, _int(sec, "from", 0))], sec.get("activation", "linear"))
            elif kind == "upsample":
                stride = _int(sec, "stride", 2)
                x = float(sec.get("scale", 1)) * x.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3)
            elif kind in HEADS:
                heads.append((sec, x))
            outputs[index] = x
            for r in [r for r, last in self.last_use.items() if last == index]:
                outputs.pop(r, None)
        return heads

    def decode(self, sec: dict, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One head -> its candidates, cell by cell then anchor by anchor:
        (N, 4) cx, cy, w, h relative to the net input, and (N,) each one's
        best class score (objectness times class probability)."""
        classes = _int(sec, "classes", 20)
        anchors = [float(a) for a in sec["anchors"].split(",") if a]
        _, C, h, w = feat.shape
        if sec["type"] == "region":
            n = _int(sec, "num", 1)
            if _int(sec, "coords", 4) != 4:
                raise ValueError("a [region] with other than 4 coordinates")
            pairs = [(anchors[2 * a] / w, anchors[2 * a + 1] / h) for a in range(n)]
        else:
            mask = _ints(sec, "mask") if "mask" in sec else list(range(_int(sec, "num", 1)))
            n = len(mask)
            pairs = [(anchors[2 * m] / self.net_w, anchors[2 * m + 1] / self.net_h) for m in mask]
        if C != n * (5 + classes):
            raise ValueError(f"a head of {C} channels for {n} anchors and {classes} classes")
        f = feat[0].reshape(n, 5 + classes, h, w).permute(2, 3, 0, 1)   # (h, w, anchor, entry)
        gx = torch.arange(w, device=feat.device, dtype=torch.float32)[None, :, None]
        gy = torch.arange(h, device=feat.device, dtype=torch.float32)[:, None, None]
        aw = torch.tensor([p[0] for p in pairs], device=feat.device, dtype=torch.float32)
        ah = torch.tensor([p[1] for p in pairs], device=feat.device, dtype=torch.float32)
        logistic = lambda v: 1.0 / (1.0 + torch.exp(-v))  # noqa: E731
        box = torch.stack([(gx + logistic(f[..., 0])) / w, (gy + logistic(f[..., 1])) / h,
                           torch.exp(f[..., 2]) * aw, torch.exp(f[..., 3]) * ah], dim=-1)
        objectness = logistic(f[..., 4])
        if sec["type"] == "region" and _int(sec, "softmax", 0):
            cls = torch.softmax(f[..., 5:], dim=-1)
        else:
            cls = logistic(f[..., 5:])
        prob = (objectness[..., None] * cls).amax(dim=-1)
        return box.reshape(-1, 4), prob.reshape(-1)

    def unletterbox(self, box: torch.Tensor, img_w: int, img_h: int) -> torch.Tensor:
        """(N, 4) cx, cy, w, h of the net input -> x1, y1, x2, y2 image px."""
        scale = min(self.net_w / img_w, self.net_h / img_h)
        ox, oy = (self.net_w - img_w * scale) / 2.0, (self.net_h - img_h * scale) / 2.0
        cx = (box[:, 0] * self.net_w - ox) / scale
        cy = (box[:, 1] * self.net_h - oy) / scale
        half_w, half_h = box[:, 2] * self.net_w / scale / 2, box[:, 3] * self.net_h / scale / 2
        return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=1)

    def nms(self, boxes: np.ndarray, probs: np.ndarray, score_edge: float = 0.0,
            iou_edge: float = 0.0) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Greedy NMS (``do_nms_sort``) of the candidates whose best class
        score (``probs``) passes the threshold: by score, the first on ties,
        each kept box zeroing the later ones above ``nms_iou`` (``box_iou`` on
        centres and sizes); the first ``max_boxes`` kept, padded with invalid
        slots.  -> (boxes, valid, edge, optional).

        ``edge`` marks the kept slots, and ``optional`` holds the boxes of
        every candidate, kept or not, whose fate rounding could turn: its
        score within ``score_edge`` of the threshold, a compared IoU within
        ``iou_edge`` of ``nms_iou``, an order against a close score that
        decides a suppression or the cut to ``max_boxes``, or a suppression by
        such a candidate.  The other kept boxes are due from any sound
        program."""
        conf = np.float32(self.conf)
        scores = np.where(probs > conf, probs, 0)
        order = [int(i) for i in np.argsort(-scores, kind="stable") if scores[i] > 0]
        cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
        bw, bh = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]

        def overlap(c1, w1, c2, w2):
            return min(c1 + w1 / 2, c2 + w2 / 2) - max(c1 - w1 / 2, c2 - w2 / 2)

        def iou(i, j):
            ow, oh = overlap(cx[i], bw[i], cx[j], bw[j]), overlap(cy[i], bh[i], cy[j], bh[j])
            inter = 0.0 if ow < 0 or oh < 0 else ow * oh
            return inter / (bw[i] * bh[i] + bw[j] * bh[j] - inter)

        alive = {i: True for i in order}
        kept = []
        for k, i in enumerate(order):
            if not alive[i]:
                continue
            kept.append(i)
            for j in order[k + 1:]:
                if alive[j] and iou(i, j) > self.nms_iou:
                    alive[j] = False
        kept = kept[:self.max_boxes]

        # the same decisions with their edges: "in", "out" or "edge"
        maybe = [int(i) for i in np.argsort(-probs, kind="stable") if probs[i] > conf - score_edge]
        tied = set()   # two close scores whose order decides a suppression
        for k, i in enumerate(maybe):
            for j in maybe[:k]:
                if probs[j] - probs[i] < score_edge and iou(j, i) > self.nms_iou - iou_edge:
                    tied |= {i, j}
        status: dict[int, str] = {}
        for k, i in enumerate(maybe):
            s = "edge" if abs(probs[i] - conf) < score_edge or i in tied else "in"
            for j in maybe[:k]:
                if status[j] == "out":
                    continue
                v = iou(j, i)
                if v > self.nms_iou - iou_edge:
                    if status[j] == "in" and v > self.nms_iou + iou_edge:
                        s = "out"
                        break
                    s = "edge"
            status[i] = s
        left = [(i, status[i]) for i in maybe if status[i] != "out"]
        for k, (i, _) in enumerate(left):   # the cut: how many boxes surely, and how many perhaps, come before i
            surely = sum(s == "in" and probs[j] - probs[i] >= score_edge for j, s in left[:k])
            perhaps = sum(j != i and (s == "edge" and probs[j] >= probs[i] - score_edge
                                      or s == "in" and abs(probs[j] - probs[i]) < score_edge)
                          for j, s in left)
            if surely >= self.max_boxes:
                status[i] = "out"
            elif surely + perhaps >= self.max_boxes:
                status[i] = "edge"

        out = np.zeros((self.max_boxes, 4), np.float32)
        valid = np.zeros(self.max_boxes, bool)
        edge = np.zeros(self.max_boxes, bool)
        out[:len(kept)] = boxes[kept]
        valid[:len(kept)] = True
        edge[:len(kept)] = [status.get(i) != "in" for i in kept]
        optional = np.asarray([boxes[i] for i in maybe if status[i] == "edge"], np.float32).reshape(-1, 4)
        return out, valid, edge, optional

    def detect(self, gray: torch.Tensor, tf32: bool = False, edges: tuple[float, float] = (0.0, 0.0)) -> Detections:
        """(H, W) grey in [0, 1] on the detector's device -> the head maps and
        the boxes after NMS; ``edges``: the score and IoU distances from a
        decision's edge within which rounding could turn it."""
        img_h, img_w = gray.shape
        with torch.no_grad(), arithmetic(tf32):
            heads = self.forward(letterbox(gray, self.net_w, self.net_h))
            boxes, scores = [], []
            for sec, feat in heads:
                box, prob = self.decode(sec, feat)
                boxes.append(self.unletterbox(box, img_w, img_h))
                scores.append(prob)
        kept = self.nms(torch.cat(boxes).cpu().numpy(), torch.cat(scores).cpu().numpy(), *edges)
        return Detections([feat for _, feat in heads], *kept)
