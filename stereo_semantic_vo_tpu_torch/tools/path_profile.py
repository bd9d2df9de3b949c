"""Host ms/frame and device busy time of one tracking path on one CUDA
card, for whichever checkout of the port is first on ``sys.path``:

    PYTHONPATH=<checkout> python3 stereo_semantic_vo_tpu_torch/tools/path_profile.py --path {sparse,dense,knob,online,steered} --label NAME

``--path dense`` (the default) is the dense + window-BA path
(``sparse_mode="dense"``, window BA every frame); ``--path sparse`` the
main path, ``VOConfig.kitti()`` as it is; ``--path knob`` the sparse path
with the FAST kernel and the fused motion-BA build (``orb.fast_backend``
and ``ba.hessian_backend`` = "pallas"); ``--path online`` the sparse path
with online detection (``zoo.kitti_tiny_v2`` with random weights on a
side CUDA stream, one frame late, in place of the offline boxes);
``--path steered`` the sparse path with steered BRIEF (``orb.steer``).  It drives
``VOPipeline`` (which replays CUDA graphs of its step where the checkout
has them) of ``VOConfig.kitti("00")`` over the procedural 1241x376
two-plane sequence (a detection box every fifth frame, as
``chip_smoke.py`` feeds it): ``--warmup`` frames, then ``--frames`` frames
timed on the host clock (median ms/frame), then ``--frames`` more under
``torch.profiler`` (CUDA activity only) for, per frame: the device time
summed over every kernel and copy, its share of the profiled host time and
the idle rest, the kernels and the copies or fills on the device, the
profiler's entries (``device_ops_per_frame``, which also counts the
runtime's launch calls), and the device time of each hand-written kernel.
Prints one JSON line."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
from stereo_semantic_vo_tpu_torch.models import zoo

# the hand-written kernels, by a part of their names
HAND_KERNELS = ("extract_patches", "keypoint_stereo", "fused_best_match", "fast_scores", "motion_hessian",
                "sgm_", "local_ba_blocks", "hamming_matrix", "dense_cost_volumes")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("sparse", "dense", "knob", "online", "steered"), default="dense")
    ap.add_argument("--label", default="")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("path_profile: needs a CUDA card")
    k = VOConfig.kitti("00")
    if args.path in ("sparse", "online"):
        cfg = k
    elif args.path == "steered":
        cfg = dataclasses.replace(k, orb=dataclasses.replace(k.orb, steer=True))
    elif args.path == "dense":
        cfg = dataclasses.replace(k, stereo=dataclasses.replace(k.stereo, sparse_mode="dense"))
    else:
        cfg = dataclasses.replace(k, orb=dataclasses.replace(k.orb, fast_backend="pallas"),
                                  ba=dataclasses.replace(k.ba, hessian_backend="pallas"))
    src = two_plane_frame_source(cfg.camera.height, cfg.camera.width)
    detector = zoo.kitti_tiny_v2(device="cuda") if args.path == "online" else None
    pipe = VOPipeline(cfg, device="cuda", local_ba_every=1 if args.path == "dense" else 0, write_trajectory=False,
                      detector=detector)
    nb = cfg.semantic.max_boxes

    def feed(t: int) -> None:
        left, right = src(t)
        if detector is not None:
            pipe.process_frame(left, right, None, None, t / cfg.camera.fps)
            return
        boxes, valid = np.zeros((nb, 4), np.float32), np.zeros(nb, bool)
        if t % 5 == 2:
            boxes[0], valid[0] = [500.0, 60.0, 700.0, 300.0], True
        pipe.process_frame(left, right, boxes, valid, t / cfg.camera.fps)

    n0, n = args.warmup, args.frames
    for t in range(n0):
        feed(t)
    torch.cuda.synchronize()
    wall = []
    for t in range(n0, n0 + n):
        t0 = time.perf_counter()
        feed(t)
        wall.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n0 + n, n0 + 2 * n):
            feed(t)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    pipe.flush()
    def device_ms(e) -> float:
        return (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)) / 1e3

    busy = count = 0.0
    for e in prof.key_averages():
        busy += device_ms(e)
        count += e.count
    kernels = copies = 0
    hand = {name: 0.0 for name in HAND_KERNELS}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
            continue
        kernels += 1
        for name in HAND_KERNELS:
            if name in e.name:
                hand[name] += device_ms(e)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    share = busy / (prof_wall * 1e3)
    print(json.dumps({
        "label": args.label, "path": args.path, "card": card, "frames": n,
        "host_ms_per_frame_median": float(np.median(wall)) * 1e3,
        "device_busy_ms_per_frame": busy / n,
        "device_busy_share_of_profiled_wall": share,
        "device_idle_share_of_profiled_wall": 1.0 - share,
        "kernels_per_frame": kernels / n,
        "copies_and_fills_per_frame": copies / n,
        "device_ops_per_frame": count / n,
        "hand_kernel_device_ms_per_frame": {name: ms / n for name, ms in hand.items()},
        "tracked": all(bool(o.pnp_ok) for o in pipe.outputs[1:]),
    }), flush=True)


if __name__ == "__main__":
    main()
