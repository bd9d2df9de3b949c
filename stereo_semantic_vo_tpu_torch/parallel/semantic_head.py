"""The detector replicated over a mesh's data axis.

Port of ``stereo_semantic_vo_tpu.parallel.semantic_head``: the YOLO
weights go to every device of the data axis, and a batch of frames is
split over them in contiguous blocks, as ``shard_map`` splits it.  Each
device runs its block as one batched program, the counterpart of the
reference's ``jax.vmap(detect_one)``: the block letterboxed, one forward of
(n, 3, net_h, net_w), the heads decoded, the boxes mapped back to the
image, and the greedy NMS of every image at once (``models/yolo``'s
``nms_fixed_batch``, bit for bit ``nms_fixed`` of each image).  As in the
reference, ``classes`` is all zeros.  On the CPU the forward runs an image
at a time inside the program: the CPU's convolutions round differently at
another batch size, and so each image's detections stay bit for bit those
of ``YoloDetector.detect``.

On a card, each device's block runs on a CUDA stream of its own, so the
devices run at once, and nothing reads back to the host.  There the
program is a CUDA graph (``core/cuda_graph.Graph``), one a device and block
size, captured at the first batch of that size into a pool of the device
whose capture stream is the device's stream, with a static (n, H, W, 3)
input buffer; ``capture=False`` dispatches the program eagerly (the
counterpart of ``jax.disable_jit``), and the CPU always does.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.core.cuda_graph import Graph, capture_pool
from stereo_semantic_vo_tpu_torch.core.precision import f32_matmul
from stereo_semantic_vo_tpu_torch.io import darknet
from stereo_semantic_vo_tpu_torch.models.yolo import (
    Detections,
    YoloDetector,
    letterbox_batch,
    nms_fixed_batch,
)
from stereo_semantic_vo_tpu_torch.parallel.mesh import Mesh


def detect_block(det: YoloDetector, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, H, W, 3) images in [0, 1] on ``det``'s device -> (boxes (n,
    max_boxes, 4), scores (n, max_boxes), valid (n, max_boxes)): the
    reference's ``detect_one`` of each image, in one batched program."""
    img_h, img_w = images.shape[1], images.shape[2]
    x = letterbox_batch(images, det.net_w, det.net_h, img_w, img_h).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad(), f32_matmul():
        if x.is_cuda:
            heads = det.net(x)
        else:  # the CPU's convolutions round by batch size: a forward an image keeps each one detect's
            each = [det.net(x[i : i + 1]) for i in range(x.shape[0])]
            heads = [(sec, torch.cat([h[k][1] for h in each])) for k, (sec, _) in enumerate(each[0])]
        boxes_px, scores, _ = det.candidates(heads, img_w, img_h)
        return nms_fixed_batch(boxes_px, scores, det.max_boxes, det.nms_iou)


def make_replicated_detector(
    mesh: Mesh,
    cfg_text: str,
    weights_bytes: bytes | None = None,
    conf_threshold: float = 0.8,
    nms_iou: float = 0.45,
    max_boxes: int = 32,
    img_hw: tuple[int, int] = (376, 1241),
    seed: int = 0,
    capture: bool | None = None,
):
    """-> detect_batch(images (B, H, W, 3) float32 in [0, 1]) -> Detections
    with a leading batch axis, on the mesh's first device.  B must be a
    multiple of the data axis' size.  Without ``weights_bytes`` the
    weights are darknet's random ones from ``seed``, as the reference's.
    ``capture`` (default: on CUDA devices) replays each device's block
    from a CUDA graph; ``capture=True`` on another device raises.
    ``detect_batch.graphs`` maps (device index, block size) to its
    ``Graph``."""
    if capture is None:
        capture = all(d.type == "cuda" for d in mesh.devices)
    if capture and any(d.type != "cuda" for d in mesh.devices):
        raise ValueError(f"CUDA graphs need CUDA devices, got {list(mesh.devices)}")
    sections = darknet.parse_cfg(cfg_text)
    if weights_bytes is not None:
        params = darknet.load_weights(sections, weights_bytes)
    else:
        params = darknet.random_weights(sections, seed)
    dets = [YoloDetector.from_params(cfg_text, params, conf_threshold, nms_iou, max_boxes, device=d)
            for d in mesh.devices]
    img_h, img_w = img_hw
    # a device's pool; its capture stream is the stream the device's blocks run on
    pools = [capture_pool(d) if d.type == "cuda" else None for d in mesh.devices]
    graphs: dict[tuple[int, int], tuple[Graph, torch.Tensor]] = {}

    def graph(i: int, per: int) -> tuple[Graph, torch.Tensor]:
        """Device i's program on a static (per, H, W, 3) buffer."""
        if (i, per) not in graphs:
            det = dets[i]
            static = torch.zeros((per, img_h, img_w, 3), dtype=torch.float32, device=det.device)
            graphs[i, per] = (Graph(lambda: detect_block(det, static), pools[i], det.device), static)
        return graphs[i, per]

    def detect_batch(images: torch.Tensor) -> Detections:
        B, n = images.shape[0], len(dets)
        if B % n or tuple(images.shape[1:3]) != (img_h, img_w):
            raise ValueError(f"expected (k * {n}, {img_h}, {img_w}, 3) images, got {tuple(images.shape)}")
        per, outs = B // n, []
        for i, (det, pool) in enumerate(zip(dets, pools)):
            block = images[i * per : (i + 1) * per]
            if pool is None:
                outs.append(detect_block(det, block.to(det.device)))
                continue
            s = pool.stream
            s.wait_stream(torch.cuda.current_stream(det.device))
            with torch.cuda.stream(s):
                if capture:
                    g, static = graph(i, per)
                    static.copy_(block, non_blocking=True)
                    outs.append(g())
                else:
                    outs.append(detect_block(det, block.to(det.device, non_blocking=True)))
            if block.is_cuda:
                block.record_stream(s)
        for d, pool in zip(mesh.devices, pools):
            if pool is not None:
                torch.cuda.current_stream(d).wait_stream(pool.stream)
        for x in (x for o in outs for x in o if x.is_cuda):  # copied on the main streams below
            x.record_stream(torch.cuda.current_stream(x.device))
        first = mesh.devices[0]
        # the concatenation copies a graph's outputs before its next replay overwrites them
        b, sc, v = (torch.cat([o[j].to(first, non_blocking=True) for o in outs]) for j in range(3))
        return Detections(boxes=b, scores=sc, classes=torch.zeros(sc.shape, dtype=torch.int32, device=first), valid=v)

    detect_batch.graphs = graphs
    return detect_batch
