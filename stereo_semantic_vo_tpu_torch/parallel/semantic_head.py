"""The detector replicated over a mesh's data axis.

Port of ``stereo_semantic_vo_tpu.parallel.semantic_head``: the YOLO
weights go to every device of the data axis, and a batch of frames is
split over them in contiguous blocks, as ``shard_map`` splits it.  Each
device runs ``models/yolo.YoloDetector.detect`` on its own frames; on a
card, each device's frames are enqueued on a CUDA stream of its own, and
nothing reads back to the host.  As in the reference, ``classes`` is all
zeros.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.io import darknet
from stereo_semantic_vo_tpu_torch.models.yolo import Detections, YoloDetector
from stereo_semantic_vo_tpu_torch.parallel.mesh import Mesh


def make_replicated_detector(
    mesh: Mesh,
    cfg_text: str,
    weights_bytes: bytes | None = None,
    conf_threshold: float = 0.8,
    nms_iou: float = 0.45,
    max_boxes: int = 32,
    img_hw: tuple[int, int] = (376, 1241),
    seed: int = 0,
):
    """-> detect_batch(images (B, H, W, 3) float32 in [0, 1]) -> Detections
    with a leading batch axis, on the mesh's first device.  B must be a
    multiple of the data axis' size.  Without ``weights_bytes`` the
    weights are darknet's random ones from ``seed``, as the reference's."""
    sections = darknet.parse_cfg(cfg_text)
    if weights_bytes is not None:
        params = darknet.load_weights(sections, weights_bytes)
    else:
        params = darknet.random_weights(sections, seed)
    dets = [YoloDetector.from_params(cfg_text, params, conf_threshold, nms_iou, max_boxes, device=d)
            for d in mesh.devices]
    img_h, img_w = img_hw
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in mesh.devices]

    def detect_batch(images: torch.Tensor) -> Detections:
        B, n = images.shape[0], len(dets)
        if B % n or tuple(images.shape[1:3]) != (img_h, img_w):
            raise ValueError(f"expected (k * {n}, {img_h}, {img_w}, 3) images, got {tuple(images.shape)}")
        per, outs = B // n, []
        for i, (det, s) in enumerate(zip(dets, streams)):
            block = images[i * per : (i + 1) * per]
            if s is None:
                outs += [det.detect(img) for img in block.to(det.device)]
                continue
            s.wait_stream(torch.cuda.current_stream(det.device))
            with torch.cuda.stream(s):
                block = block.to(det.device, non_blocking=True)
                outs += [det.detect(img) for img in block]
            block.record_stream(s)
        for d, s in zip(mesh.devices, streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)
        for x in (x for o in outs for x in o if x.is_cuda):  # stacked on the main streams below
            x.record_stream(torch.cuda.current_stream(x.device))
        first = mesh.devices[0]
        b, sc, v = (torch.stack([getattr(o, f).to(first, non_blocking=True) for o in outs])
                    for f in ("boxes", "scores", "valid"))
        return Detections(boxes=b, scores=sc, classes=torch.zeros(sc.shape, dtype=torch.int32, device=first), valid=v)

    return detect_batch
