"""YOLO training path: darknet's trainer as one autograd step on a device.

Port of ``stereo_semantic_vo_tpu.models.yolo_train`` (the reference's
Thirdparty/darknet/src/detector.c train_detector, network.c
get_current_rate :90, region_layer.c forward_region_layer :158,
yolo_layer.c forward_yolo_layer :132, batchnorm_layer.c :135 and the
convolutional_layer.c update):

* ``YoloTrainNet``: the cfg graph with live batch-norm (batch statistics,
  Bessel-corrected variance, eps on the standard deviation, rolling stats
  0.99 / 0.01), the trainable leaves as ``nn.Parameter``s and the rolling
  statistics as buffers.  NCHW inside; cuDNN convolutions on a card, with
  TF32 off for the forward and the backward pass (``core/precision``);
* ``region_loss`` (YOLOv2) and ``yolo_loss`` (YOLOv3) with darknet's
  assignment rules, defined on the activated outputs so that autograd
  applies the exact logistic / softmax Jacobians, as the JAX package does;
* ``device_learning_rate``: darknet's policies and burn-in ramp as a
  function of a device counter, and ``learning_rate``, its host value;
* ``YoloTrainer``: SGD with momentum and conv-weight decay, updated in
  place under ``no_grad``; on a card the whole step (forward, losses,
  ``torch.autograd.grad``, the update and the counters) is one CUDA graph,
  the counterpart of the reference's ``jax.jit`` of the step.

Four details keep it equal to the JAX package:

- head maps are permuted to NHWC before they are split per anchor, so
  anchor and channel line up as in JAX's NHWC layout;
- the scan over truth slots is a Python loop whose step writes out of
  place with ``index_put``, the value ``where(valid, v, d[idx])``, so a
  later truth overwrites an earlier one on the same cell and anchor;
- the class one-hot compares with an ``arange`` (no ``F.one_hot``, whose
  range check reads the device);
- ``seen`` and ``batch_num`` are 0-d int32 device tensors, as the JAX
  ``TrainState``'s are: the burn-in is a device select and the learning
  rate a device function of the counter, so a step's dispatch reads
  nothing back and a captured step advances them on every replay.
  ``train_step`` reads the loss once.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stereo_semantic_vo_tpu_torch.core.cuda_graph import Graph, capture_pool
from stereo_semantic_vo_tpu_torch.core.precision import f32_matmul
from stereo_semantic_vo_tpu_torch.io import darknet
from stereo_semantic_vo_tpu_torch.models.yolo import LEAKY_SLOPE, _conv_same, _maxpool

MAX_TRUTHS = 30  # darknet l.truths = 30 boxes per image (region_layer.c:33)
BURN_IN_SEEN = 12800  # coord burn-in horizon (region_layer.c:255)
TRAINABLE = ("w", "b", "scales")


# --------------------------------------------------------------------------
# trainable forward (live batch-norm)
# --------------------------------------------------------------------------


def _batchnorm(x: torch.Tensor, scales, b, mean_r, var_r, train: bool):
    """Darknet batch-norm on NCHW (batchnorm_layer.c:135-155): per-channel
    mean over (N, H, W), variance divided by n - 1 (blas.c variance_cpu
    :112), normalised by sqrt(var) + 1e-6.  -> (y, rolling mean, rolling
    var), the rolling statistics detached (0.99 old + 0.01 batch in train
    mode, unchanged in eval mode)."""
    if train:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        mean = x.mean(dim=(0, 2, 3))
        var = torch.square(x - mean[None, :, None, None]).sum(dim=(0, 2, 3)) / max(n - 1, 1)
        new_rm = (0.99 * mean_r + 0.01 * mean).detach()
        new_rv = (0.99 * var_r + 0.01 * var).detach()
    else:
        mean, var = mean_r, var_r
        new_rm, new_rv = mean_r, var_r
    inv = 1.0 / (torch.sqrt(var) + 1e-6)
    y = (x - mean[None, :, None, None]) * (scales * inv)[None, :, None, None]
    return y + b[None, :, None, None], new_rm, new_rv


class YoloTrainNet(nn.Module):
    """The cfg graph on raw (unfolded) darknet params ``{layer: {"w": HWIO,
    "b", ["scales", "mean", "var"]}}`` (io/darknet.load_weights_raw).
    Parameters ``w{i}`` (OIHW), ``b{i}``, ``scales{i}``; buffers
    ``mean{i}``, ``var{i}`` and, for head h, ``anchors{h}``
    (``anchor_table``), so that a loss copies nothing to the device.

    ``forward(x, train=True)`` takes (B, 3, H, W) and returns
    ``([(head_section, feature_map (B, C, h, w)), ...], {layer: (rolling
    mean, rolling var)})``: the statistics the forward pass moved to, for
    the caller to store (the buffers are left as they were)."""

    def __init__(self, sections: list[dict[str, Any]], raw: dict[int, dict[str, np.ndarray]]):
        super().__init__()
        self.sections = sections
        self.conv_layers: list[int] = []
        self.bn_layers: list[int] = []
        self.n_heads = 0
        for li, sec in enumerate(sections[1:]):
            if sec["type"] in ("region", "yolo"):
                self.register_buffer(f"anchors{self.n_heads}", torch.from_numpy(anchor_table(sec)))
                self.n_heads += 1
            if sec["type"] != "convolutional":
                continue
            p = raw[li]
            w = np.ascontiguousarray(np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1)))
            self.register_parameter(f"w{li}", nn.Parameter(torch.from_numpy(w)))
            self.register_parameter(f"b{li}", nn.Parameter(_f32(p["b"])))
            if "scales" in p:
                self.register_parameter(f"scales{li}", nn.Parameter(_f32(p["scales"])))
                self.register_buffer(f"mean{li}", _f32(p["mean"]))
                self.register_buffer(f"var{li}", _f32(p["var"]))
                self.bn_layers.append(li)
            self.conv_layers.append(li)

    @property
    def anchors(self) -> list[torch.Tensor]:
        """Each head's ``anchor_table`` on the module's device."""
        return [getattr(self, f"anchors{i}") for i in range(self.n_heads)]

    def leaves(self, li: int) -> dict[str, torch.Tensor]:
        """Layer ``li``'s tensors by their darknet names (``w`` OIHW)."""
        names = ("w", "b", "scales", "mean", "var") if li in self.bn_layers else ("w", "b")
        return {k: getattr(self, f"{k}{li}") for k in names}

    def trainable(self) -> list[tuple[int, str, nn.Parameter]]:
        """(layer, name, parameter) of every trainable leaf, in layer order."""
        return [(li, k, v) for li in self.conv_layers for k, v in self.leaves(li).items() if k in TRAINABLE]

    def forward(self, x: torch.Tensor, train: bool = True):
        outputs: list[torch.Tensor] = []
        heads: list[tuple[dict, torch.Tensor]] = []
        rolling: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        for li, sec in enumerate(self.sections[1:]):
            t = sec["type"]
            if t == "convolutional":
                p = self.leaves(li)
                stride = int(sec.get("stride", 1))
                if li in self.bn_layers:
                    x = _conv_same(x, p["w"], None, stride)
                    x, rm, rv = _batchnorm(x, p["scales"], p["b"], p["mean"], p["var"], train)
                    rolling[li] = (rm, rv)
                else:
                    x = _conv_same(x, p["w"], p["b"], stride)
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
        return heads, rolling


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


class LossStats(NamedTuple):
    loss: torch.Tensor      # scalar: 0.5 * sum(delta^2) (darknet cost is sum)
    avg_iou: torch.Tensor   # mean IoU of assigned boxes
    recall: torch.Tensor    # fraction of truths with IoU > .5
    avg_obj: torch.Tensor   # mean objectness at assigned cells
    count: torch.Tensor     # number of assigned truths


def _iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of [cx, cy, w, h] boxes, broadcasting (box.c box_iou)."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ay1, ay2 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bx1, bx2 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    by1, by2 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / torch.clamp(union, min=1e-9)


def anchor_table(sec: dict) -> np.ndarray:
    """(n, 2) float32 anchors a loss reads: a region head's first ``num``
    (grid cells), or every anchor of a yolo head (input pixels; its mask
    selects from them)."""
    anchors = np.asarray(sec.get("anchors", ()), np.float32).reshape(-1, 2)
    return anchors[: int(sec.get("num", 5))] if sec["type"] == "region" else anchors


def _split_head(feat: torch.Tensor, n_anchor: int, nc: int) -> torch.Tensor:
    """(B, C, H, W) head map -> (B, H, W, A, 5 + nc) in JAX's NHWC order."""
    B, _, H, W = feat.shape
    return feat.permute(0, 2, 3, 1).reshape(B, H, W, n_anchor, 5 + nc)


def _grid(H: int, W: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    gx = torch.arange(W, dtype=torch.float32, device=device)[None, None, :, None]
    gy = torch.arange(H, dtype=torch.float32, device=device)[None, :, None, None]
    return gx, gy


def _best_iou(pred: torch.Tensor, truths: torch.Tensor, truths_mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W, A) best IoU of each predicted box against the valid truths."""
    t_boxes = torch.where(truths_mask[..., None], truths[..., :4], 0.0)
    iou_all = _iou_cxcywh(pred[:, :, :, :, None, :], t_boxes[:, None, None, None, :, :])
    iou_all = torch.where(truths_mask[:, None, None, None, :], iou_all, 0.0)
    return torch.amax(iou_all, dim=-1)


def _cell(tb: torch.Tensor, H: int, W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Truth centres' grid cells (column, row), truncated and clamped."""
    ci = torch.clamp((tb[:, 0] * W).to(torch.int32), 0, W - 1).long()
    cj = torch.clamp((tb[:, 1] * H).to(torch.int32), 0, H - 1).long()
    return ci, cj


def _one_hot(cls: torch.Tensor, nc: int) -> torch.Tensor:
    """(B,) float class ids -> (B, nc) float32 one-hot (all zero out of range)."""
    ids = cls.to(torch.int32).long()
    return (ids[:, None] == torch.arange(nc, device=cls.device)[None, :]).to(torch.float32)


def _setv(d: torch.Tensor, idx, ok: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``d.at[idx].set(where(ok, v, d[idx]))`` out of place."""
    cur = d[idx]
    okb = ok if v.dim() == 1 else ok[:, None]
    return d.index_put(idx, torch.where(okb, v, cur))


def _finish(deltas, iou_sum, rec, obj_sum, cnt) -> LossStats:
    sq = sum(torch.sum(torch.square(d)) for d in deltas)
    safe = torch.clamp(cnt, min=1.0)
    return LossStats(0.5 * sq, iou_sum / safe, rec / safe, obj_sum / safe, cnt)


def region_loss(
    feat: torch.Tensor,
    sec: dict,
    truths: torch.Tensor,
    truths_mask: torch.Tensor,
    seen: int = BURN_IN_SEEN,
    anchors: torch.Tensor | None = None,
) -> LossStats:
    """Darknet region-layer training loss (region_layer.c:158-319).

    feat: (B, A*(5+nc), H, W) raw head map (NCHW).  truths: (B, T, 5)
    [cx, cy, w, h, class] relative; truths_mask (B, T) bool.  seen: images
    seen so far, a host int or a 0-d device tensor (the < 12800 coord
    burn-in, :255-263, a device select as in the JAX package).
    anchors: ``anchor_table(sec)`` on feat's device (``YoloTrainNet.anchors``
    holds it there); None copies it there, which waits for the device.

    Every anchor cell gets noobject_scale * (0 - obj) unless its box has a
    best IoU above ``thresh``; during burn-in the coords are pulled to the
    anchor prior at .01; each truth goes to its centre cell and the anchor of
    best shape IoU (``bias_match``), coord scale coord_scale * (2 - w*h),
    objectness target 1 (the IoU, detached, when ``rescore=1``), classes
    one-hot.  Later truths overwrite earlier ones on collision.
    """
    B, _, H, W = feat.shape
    dev = feat.device
    A = int(sec.get("num", 5))
    nc = int(sec.get("classes", 1))
    if anchors is None:
        anchors = torch.from_numpy(anchor_table(sec)).to(dev)  # grid-cell units
    object_scale = float(sec.get("object_scale", 5))
    noobject_scale = float(sec.get("noobject_scale", 1))
    class_scale = float(sec.get("class_scale", 1))
    coord_scale = float(sec.get("coord_scale", 1))
    thresh = float(sec.get("thresh", 0.6))
    rescore = int(sec.get("rescore", 0))
    bias_match = int(sec.get("bias_match", 0))
    use_softmax = int(sec.get("softmax", 0)) == 1

    f = _split_head(feat, A, nc)
    sx = torch.sigmoid(f[..., 0])
    sy = torch.sigmoid(f[..., 1])
    tw = f[..., 2]
    th = f[..., 3]
    obj = torch.sigmoid(f[..., 4])
    cls = torch.softmax(f[..., 5:], dim=-1) if use_softmax else torch.sigmoid(f[..., 5:])

    gx, gy = _grid(H, W, dev)
    aw = anchors[:, 0][None, None, None, :]
    ah = anchors[:, 1][None, None, None, :]
    pred = torch.stack(
        [(gx + sx) / W, (gy + sy) / H, torch.exp(tw) * aw / W, torch.exp(th) * ah / H], dim=-1
    )  # (B, H, W, A, 4) relative

    T = truths.shape[1]
    best_iou = _best_iou(pred, truths, truths_mask) if T else torch.zeros_like(obj)
    d_obj = torch.where(best_iou > thresh, 0.0, noobject_scale * (0.0 - obj))

    # region_layer.c:255-263; a fill, not a copy, for a host int
    in_burn = seen < BURN_IN_SEEN if isinstance(seen, torch.Tensor) else torch.full((), seen < BURN_IN_SEEN,
                                                                                      device=dev)
    burn = 0.01
    d_x = torch.where(in_burn, burn * (0.5 - sx), 0.0)
    d_y = torch.where(in_burn, burn * (0.5 - sy), 0.0)
    d_w = torch.where(in_burn, burn * (0.0 - tw), 0.0)  # log(anchor/anchor) = 0
    d_h = torch.where(in_burn, burn * (0.0 - th), 0.0)
    d_cls = torch.zeros_like(cls)

    bidx = torch.arange(B, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iou_sum = rec = obj_sum = cnt = zero
    for t in range(T):
        tb = truths[:, t, :]
        valid = truths_mask[:, t]
        ci, cj = _cell(tb, H, W)
        # best anchor by shape IoU at the origin (bias_match: anchor w/h)
        if bias_match:
            cand_w = (anchors[:, 0] / W)[None, :]
            cand_h = (anchors[:, 1] / H)[None, :]
        else:
            cand_w = torch.exp(tw[bidx, cj, ci]) * anchors[:, 0][None, :] / W
            cand_h = torch.exp(th[bidx, cj, ci]) * anchors[:, 1][None, :] / H
        zc = torch.zeros_like(cand_w)
        shape_pred = torch.stack([zc, zc, cand_w, cand_h], -1)
        shape_truth = torch.cat([torch.zeros((B, 2), device=dev), tb[:, 2:4]], dim=-1)
        an = torch.argmax(_iou_cxcywh(shape_pred, shape_truth[:, None, :]), dim=-1)

        scale = coord_scale * (2.0 - tb[:, 2] * tb[:, 3])
        tx = tb[:, 0] * W - ci.to(torch.float32)
        ty = tb[:, 1] * H - cj.to(torch.float32)
        tw_t = torch.log(torch.clamp(tb[:, 2] * W / anchors[an, 0], min=1e-9))
        th_t = torch.log(torch.clamp(tb[:, 3] * H / anchors[an, 1], min=1e-9))

        idx = (bidx, cj, ci, an)
        iou_t = _iou_cxcywh(pred[idx], tb[:, :4])
        obj_here = obj[idx]
        obj_target = iou_t.detach() if rescore == 1 else torch.ones_like(iou_t)

        d_x = _setv(d_x, idx, valid, scale * (tx - sx[idx]))
        d_y = _setv(d_y, idx, valid, scale * (ty - sy[idx]))
        d_w = _setv(d_w, idx, valid, scale * (tw_t - tw[idx]))
        d_h = _setv(d_h, idx, valid, scale * (th_t - th[idx]))
        d_obj = _setv(d_obj, idx, valid, object_scale * (obj_target - obj_here))
        d_cls = _setv(d_cls, idx, valid, class_scale * (_one_hot(tb[:, 4], nc) - cls[idx]))
        iou_sum = iou_sum + torch.sum(torch.where(valid, iou_t, 0.0))
        rec = rec + torch.sum(torch.where(valid & (iou_t > 0.5), 1.0, 0.0))
        obj_sum = obj_sum + torch.sum(torch.where(valid, obj_here, 0.0))
        cnt = cnt + torch.sum(valid.to(torch.float32))

    return _finish((d_x, d_y, d_w, d_h, d_obj, d_cls), iou_sum, rec, obj_sum, cnt)


def yolo_loss(
    feat: torch.Tensor,
    sec: dict,
    truths: torch.Tensor,
    truths_mask: torch.Tensor,
    net_w: int,
    net_h: int,
    anchors: torch.Tensor | None = None,
) -> LossStats:
    """Darknet yolo-layer (v3) training loss (yolo_layer.c:132-220).

    feat: (B, len(mask)*(5+nc), H, W) raw head map (NCHW).  Anchors in input
    pixels, selected by the head's mask; every anchor cell gets (0 - obj)
    unless its best IoU exceeds ``ignore_thresh``; each truth goes to its
    centre cell and the globally best shape anchor, only where this head's
    mask holds that anchor; coord scale (2 - w*h); per-class logistic
    one-hot.  The ``truth_thresh`` branch (default 1: never taken) is left
    out, as in the JAX package.  anchors: ``anchor_table(sec)`` (every
    anchor) on feat's device, or None to copy it there.
    """
    B, _, H, W = feat.shape
    dev = feat.device
    mask = sec.get("mask", (0, 1, 2))
    if not isinstance(mask, tuple):
        mask = (mask,)
    mask = tuple(int(m) for m in mask)
    A = len(mask)
    all_anchors = torch.from_numpy(anchor_table(sec)).to(dev) if anchors is None else anchors  # (A_total, 2)
    anchors = torch.stack([all_anchors[m] for m in mask])  # (A, 2) input px
    n_all = all_anchors.shape[0]
    nc = int(sec.get("classes", 1))
    ignore_thresh = float(sec.get("ignore_thresh", 0.5))

    f = _split_head(feat, A, nc)
    sx = torch.sigmoid(f[..., 0])
    sy = torch.sigmoid(f[..., 1])
    tw = f[..., 2]
    th = f[..., 3]
    obj = torch.sigmoid(f[..., 4])
    cls = torch.sigmoid(f[..., 5:])

    gx, gy = _grid(H, W, dev)
    pred = torch.stack(
        [
            (gx + sx) / W,
            (gy + sy) / H,
            torch.exp(tw) * anchors[:, 0][None, None, None, :] / net_w,
            torch.exp(th) * anchors[:, 1][None, None, None, :] / net_h,
        ],
        dim=-1,
    )
    best_iou = _best_iou(pred, truths, truths_mask)
    d_obj = torch.where(best_iou > ignore_thresh, 0.0, 0.0 - obj)

    d_x = d_y = d_w = d_h = torch.zeros_like(sx)
    d_cls = torch.zeros_like(cls)
    bidx = torch.arange(B, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iou_sum = rec = obj_sum = cnt = zero
    zeros_all = torch.zeros((B, n_all), device=dev)
    shape_pred = torch.stack(
        [zeros_all, zeros_all, (all_anchors[:, 0] / net_w).expand(B, n_all),
         (all_anchors[:, 1] / net_h).expand(B, n_all)], -1)
    for t in range(truths.shape[1]):
        tb = truths[:, t, :]
        valid = truths_mask[:, t]
        ci, cj = _cell(tb, H, W)
        # global best anchor by shape IoU (yolo_layer.c:199-210)
        shape_truth = torch.cat([torch.zeros((B, 2), device=dev), tb[:, 2:4]], dim=-1)
        best_n = torch.argmax(_iou_cxcywh(shape_pred, shape_truth[:, None, :]), dim=-1)
        # position of best_n inside this head's mask (0 where absent)
        in_mask = torch.stack([best_n == m for m in mask], -1)  # (B, A)
        an = torch.argmax(in_mask.to(torch.int32), dim=-1)
        ok = valid & torch.any(in_mask, dim=-1)

        scale = 2.0 - tb[:, 2] * tb[:, 3]
        tx = tb[:, 0] * W - ci.to(torch.float32)
        ty = tb[:, 1] * H - cj.to(torch.float32)
        tw_t = torch.log(torch.clamp(tb[:, 2] * net_w / all_anchors[best_n, 0], min=1e-9))
        th_t = torch.log(torch.clamp(tb[:, 3] * net_h / all_anchors[best_n, 1], min=1e-9))
        idx = (bidx, cj, ci, an)
        iou_t = _iou_cxcywh(pred[idx], tb[:, :4])
        obj_here = obj[idx]

        d_x = _setv(d_x, idx, ok, scale * (tx - sx[idx]))
        d_y = _setv(d_y, idx, ok, scale * (ty - sy[idx]))
        d_w = _setv(d_w, idx, ok, scale * (tw_t - tw[idx]))
        d_h = _setv(d_h, idx, ok, scale * (th_t - th[idx]))
        d_obj = _setv(d_obj, idx, ok, 1.0 - obj_here)
        d_cls = _setv(d_cls, idx, ok, _one_hot(tb[:, 4], nc) - cls[idx])
        iou_sum = iou_sum + torch.sum(torch.where(ok, iou_t, 0.0))
        rec = rec + torch.sum(torch.where(ok & (iou_t > 0.5), 1.0, 0.0))
        obj_sum = obj_sum + torch.sum(torch.where(ok, obj_here, 0.0))
        cnt = cnt + torch.sum(ok.to(torch.float32))

    return _finish((d_x, d_y, d_w, d_h, d_obj, d_cls), iou_sum, rec, obj_sum, cnt)


# --------------------------------------------------------------------------
# learning-rate schedule (network.c get_current_rate :90)
# --------------------------------------------------------------------------


def learning_rate(net_sec: dict, batch_num: int) -> float:
    """Darknet's learning-rate policy at optimizer step ``batch_num``, a
    host float: :func:`device_learning_rate` on the CPU."""
    return float(device_learning_rate(net_sec, torch.tensor(batch_num, dtype=torch.int32)))


def device_learning_rate(net_sec: dict, batch_num: torch.Tensor) -> torch.Tensor:
    """:func:`learning_rate` as a 0-d float32 tensor on ``batch_num``'s
    device, a function of the counter there (the JAX package's jittable
    ``learning_rate``): nothing is read back, so a captured step follows
    the schedule on every replay."""
    lr = float(net_sec.get("learning_rate", 1e-3))
    burn_in = int(net_sec.get("burn_in", 0))
    power = float(net_sec.get("power", 4))
    policy = str(net_sec.get("policy", "constant")).strip()
    b = batch_num.to(torch.float32)
    const = torch.full((), lr, dtype=torch.float32, device=b.device)

    if policy == "steps":
        steps = net_sec.get("steps", ())
        scales = net_sec.get("scales", ())
        if not isinstance(steps, tuple):
            steps, scales = (steps,), (scales,)
        rate = const
        for s, sc in zip(steps, scales):
            rate = torch.where(b >= float(s), rate * float(sc), rate)
    elif policy == "step":
        rate = lr * torch.pow(float(net_sec.get("scale", 1.0)), torch.floor(b / float(net_sec.get("step", 1))))
    elif policy == "exp":
        rate = lr * torch.pow(float(net_sec.get("gamma", 1.0)), b)
    elif policy == "poly":
        mb = float(net_sec.get("max_batches", 1))
        rate = lr * torch.pow(torch.clamp(1.0 - b / mb, min=0.0), power)
    elif policy == "sig":
        gamma = float(net_sec.get("gamma", 1.0))
        step = float(net_sec.get("step", 1))
        rate = lr / (1.0 + torch.exp(gamma * (b - step)))
    else:  # constant / random (random is for training-time jitter; use lr)
        rate = const

    if burn_in > 0:
        rate = torch.where(b < burn_in, lr * torch.pow(b / burn_in, power), rate)
    return rate


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------


class TrainState(NamedTuple):
    params: dict[int, dict[str, torch.Tensor]]    # {layer: {"w" OIHW, "b"[, "scales", "mean", "var"]}}
    momentum: dict[int, dict[str, torch.Tensor]]  # the trainable leaves' momentum buffers
    batch_num: torch.Tensor  # 0-d int32 optimizer steps (darknet *net.seen / batch)
    seen: torch.Tensor       # 0-d int32 images seen (drives the region burn-in)


class YoloTrainer:
    """cfg-driven trainer: one autograd step of SGD with momentum and decay.

    The analogue of darknet's train_detector loop (detector.c) without the
    disk-based data loader: feed (images, truths, truths_mask) batches.
    Trainable leaves are conv weights and biases and BN scales (darknet
    updates exactly these, convolutional_layer.c); the BN rolling mean and
    variance follow the forward pass.  Weight decay hits conv weights only,
    scaled by the cfg's batch as darknet does (axpy -decay*batch).
    ``device`` defaults to the card; pass ``"cpu"`` to train on the CPU.

    ``capture`` (default: on a card) runs each step as a CUDA graph
    (core/cuda_graph.Graph): the first step of a batch shape runs eagerly and
    captures forward, losses, ``torch.autograd.grad``, the update and the
    counters into a graph over static input buffers, in a memory pool of
    the trainer's; later steps of that shape copy their batch into the
    buffers and replay it.  A capture or a replay that fails raises.
    ``capture=False`` dispatches the step eagerly; the CPU always does.
    """

    def __init__(self, cfg_text: str, weights_bytes: bytes | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", capture: bool | None = None):
        self.sections = darknet.parse_cfg(cfg_text)
        net = self.sections[0]
        self.net_sec = net
        self.net_w = int(net.get("width", 416))
        self.net_h = int(net.get("height", 416))
        self.batch = int(net.get("batch", 1))
        self.momentum_coef = float(net.get("momentum", 0.9))
        self.decay = float(net.get("decay", 0.0))
        if weights_bytes is not None:
            raw = darknet.load_weights_raw(self.sections, weights_bytes)
        else:
            raw = darknet.random_weights_raw(self.sections, seed)
        self.device = torch.device(device)
        self.net = YoloTrainNet(self.sections, raw).to(self.device)
        self.momentum = {li: {k: torch.zeros_like(v) for k, v in self.net.leaves(li).items() if k in TRAINABLE}
                         for li in self.net.conv_layers}
        self._batch_num = torch.zeros((), dtype=torch.int32, device=self.device)
        self._seen = torch.zeros((), dtype=torch.int32, device=self.device)
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.capture = capture
        # batch shapes -> (the step's graph, its static images, truths, mask)
        self.graphs: dict[tuple, tuple[Graph, tuple[torch.Tensor, ...]]] = {}
        self._pool = capture_pool(self.device) if capture else None

    @property
    def batch_num(self) -> int:
        """Optimizer steps so far (reads the device counter)."""
        return int(self._batch_num)

    @property
    def seen(self) -> int:
        """Images seen so far (reads the device counter)."""
        return int(self._seen)

    @property
    def state(self) -> TrainState:
        """A snapshot of the parameters, statistics and momentum (copies)."""
        return TrainState(
            params={li: {k: v.detach().clone() for k, v in self.net.leaves(li).items()} for li in self.net.conv_layers},
            momentum={li: {k: v.clone() for k, v in m.items()} for li, m in self.momentum.items()},
            batch_num=self._batch_num.clone(),
            seen=self._seen.clone(),
        )

    def load_state(self, state: TrainState) -> None:
        """Continue from ``state`` (e.g. ``interop.train_state_from_numpy``)."""
        with torch.no_grad():
            for li in self.net.conv_layers:
                for k, v in self.net.leaves(li).items():
                    v.copy_(state.params[li][k])
                for k, v in self.momentum[li].items():
                    v.copy_(state.momentum[li][k])
            self._batch_num.copy_(torch.as_tensor(state.batch_num, dtype=torch.int32))
            self._seen.copy_(torch.as_tensor(state.seen, dtype=torch.int32))

    def loss(self, x: torch.Tensor, truths: torch.Tensor, truths_mask: torch.Tensor):
        """(B, 3, H, W) input -> (total loss, LossStats over the heads,
        rolling statistics of the forward pass), BN live."""
        heads, rolling = self.net(x)
        total, stats = None, None
        for (sec, feat), anchors in zip(heads, self.net.anchors):
            if sec["type"] == "region":
                s = region_loss(feat, sec, truths, truths_mask, self._seen, anchors)
            else:
                s = yolo_loss(feat, sec, truths, truths_mask, self.net_w, self.net_h, anchors)
            total = s.loss if total is None else total + s.loss
            stats = s if stats is None else LossStats(
                stats.loss + s.loss,
                (stats.avg_iou + s.avg_iou) / 2,
                (stats.recall + s.recall) / 2,
                (stats.avg_obj + s.avg_obj) / 2,
                stats.count + s.count,
            )
        return total, stats, rolling

    def step(self, images: torch.Tensor, truths: torch.Tensor, truths_mask: torch.Tensor):
        """One optimizer step, queued on the device with no readback (under
        capture, a replay of the batch shape's graph).  -> (loss, LossStats)
        as device tensors of their own."""
        if not self.capture:
            return self._step(images, truths, truths_mask)
        batch = (images, truths, truths_mask)
        key = tuple(tuple(x.shape) for x in batch)
        if key not in self.graphs:
            static = tuple(torch.empty_like(x, device=self.device) for x in batch)
            self.graphs[key] = (Graph(lambda: self._step(*static), self._pool, self.device), static)
        graph, static = self.graphs[key]
        for dst, x in zip(static, batch):
            dst.copy_(x)
        loss, stats = graph()  # the next replay overwrites these
        return loss.clone(), LossStats(*(x.clone() for x in stats))

    def _step(self, images: torch.Tensor, truths: torch.Tensor, truths_mask: torch.Tensor):
        """The step's work on the device: forward, losses, gradients, the
        update of the params, statistics, momentum and counters in place."""
        x = images.permute(0, 3, 1, 2).contiguous()
        leaves = self.net.trainable()
        with f32_matmul():
            loss, stats, rolling = self.loss(x, truths, truths_mask)
            grads = torch.autograd.grad(loss, [p for _, _, p in leaves])
        step_size = device_learning_rate(self.net_sec, self._batch_num) / self.batch
        decay_w = self.decay * self.batch
        # darknet update (convolutional_layer.c:524-542):
        #   u_t = grad + decay*batch*w + momentum * u_{t-1}
        #   w  -= (lr / batch) * u_t
        with torch.no_grad():
            for (li, key, p), g in zip(leaves, grads):
                if key == "w" and self.decay > 0:
                    g = g + decay_w * p
                u = self.momentum[li][key]
                u.copy_(g + self.momentum_coef * u)
                p.sub_(step_size * u)
            for li, (rm, rv) in rolling.items():  # rolling stats follow the forward pass
                getattr(self.net, f"mean{li}").copy_(rm)
                getattr(self.net, f"var{li}").copy_(rv)
            self._batch_num.add_(1)
            self._seen.add_(images.shape[0])
        return loss.detach(), LossStats(*(x.detach() for x in stats))

    def train_step(self, images: torch.Tensor, truths: torch.Tensor, truths_mask: torch.Tensor):
        """images (B, H, W, 3) in [0, 1] at net size; truths (B, T, 5)
        [cx, cy, w, h, class] relative; truths_mask (B, T) bool, all on the
        trainer's device.  -> (loss as a float, LossStats on the device)."""
        loss, stats = self.step(images, truths, truths_mask)
        return float(loss), stats

    def raw_params(self) -> dict[int, dict[str, np.ndarray]]:
        """The params as darknet raw numpy arrays (``w`` HWIO)."""
        out = {}
        for li in self.net.conv_layers:
            p = {k: v.detach().cpu().numpy() for k, v in self.net.leaves(li).items()}
            p["w"] = np.ascontiguousarray(np.transpose(p["w"], (2, 3, 1, 0)))
            out[li] = p
        return out

    def export_weights(self) -> bytes:
        """Serialize to darknet .weights (the reference's checkpoint format)."""
        return darknet.save_weights_raw(self.sections, self.raw_params(), seen=self.seen)

    def folded_params(self) -> dict[int, dict[str, np.ndarray]]:
        """Inference params (BN folded) for ``YoloDetector.from_params``."""
        return darknet.fold_params(self.raw_params())
