"""Detector model zoo.

Port of ``stereo_semantic_vo_tpu.models.zoo``, with the same cfg text:

* ``kitti_tiny_v2`` — the shipped KITTI car detector architecture
  (bin/kitti/yolov2-tiny.cfg: 9 conv + 6 maxpool, 352x352, 5 anchors,
  1 class, region head).
* ``tiny_v3`` — a yolov3-tiny-style two-head graph (route/upsample, yolo
  heads with anchor masks).

Weights load from darknet ``.weights`` blobs (io/darknet.load_weights) or
are random (He init from ``seed``); the detector runs on ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector

KITTI_TINY_V2_CFG = """
[net]
batch=1
width=352
height=352
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[convolutional]
batch_normalize=1
filters=1024
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
size=3
stride=1
pad=1
filters=512
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=30
activation=linear

[region]
anchors = 0.32908,0.78825, 0.64803,1.35694, 1.17638,2.09493, 1.55502,3.91019, 2.54330,4.9049
classes=1
coords=4
num=5
softmax=1
thresh=.6
"""

TINY_V3_CFG = """
[net]
width=416
height=416
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=256
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=1
num=6

[route]
layers = -3

[upsample]
stride=2

[route]
layers = -1, 3

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=1
num=6
"""


def kitti_tiny_v2(weights_bytes: bytes | None = None, conf_threshold: float = 0.8,
                  max_boxes: int = 32, seed: int = 0,
                  device: torch.device | str = "cuda") -> YoloDetector:
    """The reference's shipped KITTI car detector (semantic.cc online mode)."""
    return YoloDetector(
        KITTI_TINY_V2_CFG, weights_bytes=weights_bytes,
        conf_threshold=conf_threshold, max_boxes=max_boxes, seed=seed, device=device,
    )


def tiny_v3(weights_bytes: bytes | None = None, conf_threshold: float = 0.5,
            max_boxes: int = 32, seed: int = 0,
            device: torch.device | str = "cuda") -> YoloDetector:
    return YoloDetector(
        TINY_V3_CFG, weights_bytes=weights_bytes,
        conf_threshold=conf_threshold, max_boxes=max_boxes, seed=seed, device=device,
    )
