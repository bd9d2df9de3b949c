"""A darknet ``.weights`` blob made from a run's seed, for a detector whose
weights do not ship: the program loads it through its normal path
(``YoloDetector(cfg, weights_bytes=blob)``) and the reference parses the
same bytes on its own (``vo_bench/reference/detector.py``).

The numbers are drawn on the device by one generator in two calls: He-normal
convolution weights (std sqrt(2 / fan-in), darknet's
``make_convolutional_layer``) with each filter's taps shifted to sum to 0,
and batch-norm scales and rolling variances near 1 with rolling means 0.
Biases are 0, but in the convolutions that feed a [region] or [yolo] head.
With no bias and no mean the network is positively homogeneous and blind to
a flat grey: the letterbox's 0.5 border gives every head its biases alone,
and boxes come from the image's texture, spread over the frame as the
camera moves.

Two readings of the run's first frame set what training would have set,
so that a head means the same for every seed and input size.  The first
layer's rolling variances are scaled by the variance of the letterboxed
grey (the scene's uniform textures, shrunk 3.5 times from 1241x376 to 352
px, keep a standard deviation of ~0.054), which brings that layer's outputs
to order one, as batch norm would, and the He weights keep them there.  The
objectness bias, one for every anchor of every head, is set so that the
configuration's ``first_frame_candidates`` candidates of that frame have an
objectness above the confidence threshold: the boxes a frame that pass it
and NMS are then a few on every seed, where one fixed bias gave 0.1 to 12.7
a frame over 14 seeds.  It stays at least 1 below the threshold's logit,
so that the letterbox's border, which gives every head its biases alone,
never passes.  The rows that regress a box (x, y, w, h) are drawn at
``GEOMETRY_SCALE`` of He's scale, with the w and h biases at
``BOX_LOG_SCALE``: a trained head keeps its boxes near its anchors, where
He-scale rows throw them e^3 off, up to the whole frame; e^-0.7 of the
KITTI cfg's anchors is car-sized on a 1241x376 frame.
"""

from __future__ import annotations

import numpy as np
import torch

from vo_bench.reference import detector as ref
from vo_bench.scene import rng

GEOMETRY_SCALE = 0.1
BOX_LOG_SCALE = -0.7


def head_convs(sections: list[dict]) -> dict[int, tuple[int, int]]:
    """{index of the convolution before each head: (anchors, entries an anchor)}."""
    out = {}
    for index, sec in enumerate(sections[1:]):
        if sec["type"] in ref.HEADS:
            n = len(sec["mask"].split(",")) if "mask" in sec else int(sec.get("num", 1))
            out[index - 1] = (n, 5 + int(sec.get("classes", 20)))
    return out


def serialize(convs: list[ref.Conv], params: dict[int, tuple], bn: dict[int, tuple]) -> bytes:
    """darknet's layout: major 0, minor 2, "seen" as 8 bytes, then each
    convolution's biases, [scales, rolling means, rolling variances], OIHW
    weights."""
    parts = [np.array([0, 2, 0], "<i4").tobytes(), np.zeros(1, "<i8").tobytes()]
    for cv in convs:
        w, b = params[cv.index]
        parts.append(np.asarray(b, "<f4").tobytes())
        for a in bn.get(cv.index, ()):
            parts.append(np.asarray(a, "<f4").tobytes())
        parts.append(np.asarray(w, "<f4").tobytes())
    return b"".join(parts)


def blob(cfg_text: str, seed: int, detector: dict, first: np.ndarray, device: torch.device) -> bytes:
    """The weights of ``cfg_text`` for ``seed``; ``detector`` is the
    configuration's block (``conf_threshold``, ``first_frame_candidates``),
    ``first`` the run's first frame's (H, W) grey in
    [0, 255]."""
    sections = ref.parse_cfg(cfg_text)
    convs = ref.walk(sections)[1]
    heads = head_convs(sections)
    net_w, net_h = int(sections[0]["width"]), int(sections[0]["height"])
    img_h, img_w = first.shape
    new_w, new_h = ref.letterbox_size(net_w, net_h, img_w, img_h)
    oy, ox = (net_h - new_h) // 2, (net_w - new_w) // 2
    boxed = ref.letterbox(torch.from_numpy(np.ascontiguousarray(first)).to(device) / 255.0, net_w, net_h)
    contrast = float(boxed[0, 0, oy:oy + new_h, ox:ox + new_w].var())

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, 3).integers(2**62)))
    w = torch.randn(sum(cv.n * cv.c * cv.size * cv.size for cv in convs), generator=gen, device=device)
    stats = torch.rand((2, sum(cv.n for cv in convs if cv.bn)), generator=gen, device=device)
    scales, variances = (0.8 + 0.4 * stats).cpu().numpy()
    params, bn, at, at_bn = {}, {}, 0, 0
    for cv in convs:
        taps = cv.c * cv.size * cv.size
        k = w[at:at + cv.n * taps].reshape(cv.n, taps) * (2.0 / taps) ** 0.5
        at += cv.n * taps
        bias = torch.zeros(cv.n, device=device)
        if cv.index in heads:
            n, entries = heads[cv.index]
            if cv.size != 1:
                raise ValueError(f"layer {cv.index}: a head's convolution of size {cv.size}, not 1")
            k[:n * entries].view(n, entries, taps)[:, :4] *= GEOMETRY_SCALE
            bias[:n * entries].view(n, entries)[:, 2:4] = BOX_LOG_SCALE
        params[cv.index] = ((k - k.mean(dim=1, keepdim=True)).reshape(cv.n, cv.c, cv.size, cv.size), bias)
        if cv.bn:
            var = variances[at_bn:at_bn + cv.n] * (contrast if at_bn == 0 else 1.0)
            bn[cv.index] = (scales[at_bn:at_bn + cv.n], np.zeros(cv.n), var)
            at_bn += cv.n
    host = {i: (k.cpu().numpy(), b.cpu().numpy()) for i, (k, b) in params.items()}

    # the objectness bias, from the heads' logits on the first frame
    net = ref.Detector(cfg_text, serialize(convs, host, bn), 0.5, 0.5, 1, device)
    with torch.no_grad(), ref.arithmetic(False):
        logits = torch.cat([feat[0].view(n, entries, *feat.shape[2:])[:, 4].flatten()
                            for (n, entries), (_, feat) in zip([heads[i] for i in sorted(heads)], net.forward(boxed))])
    k = int(detector["first_frame_candidates"])
    top = torch.topk(logits, k + 1).values
    threshold = float(np.log(detector["conf_threshold"] / (1.0 - detector["conf_threshold"])))
    objectness = min(threshold - float(top[k - 1] + top[k]) / 2, threshold - 1.0)
    for i, (n, entries) in heads.items():
        host[i][1].reshape(-1)[4:n * entries:entries] = objectness
    return serialize(convs, host, bn)
