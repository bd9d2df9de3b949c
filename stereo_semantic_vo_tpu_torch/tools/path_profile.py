"""Host ms/frame and device busy time of the dense + window-BA path
(``sparse_mode="dense"``, window BA every frame) on one CUDA card, for
whichever checkout of the port is first on ``sys.path``:

    PYTHONPATH=<checkout> python3 stereo_semantic_vo_tpu_torch/tools/path_profile.py --label NAME

It drives ``VOPipeline`` of ``VOConfig.kitti("00")`` over the procedural
1241x376 two-plane sequence (a detection box every fifth frame, as
``chip_smoke.py`` feeds it): ``--warmup`` frames, then ``--frames`` frames
timed on the host clock (median ms/frame), then ``--frames`` more under
``torch.profiler`` (CUDA activity only) for the device time per frame
summed over every kernel and copy, its share of the host time, the
kernels per frame, and the device time of the SGM and patch kernels.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("path_profile: needs a CUDA card")
    k = VOConfig.kitti("00")
    cfg = dataclasses.replace(k, stereo=dataclasses.replace(k.stereo, sparse_mode="dense"))
    src = two_plane_frame_source(cfg.camera.height, cfg.camera.width)
    pipe = VOPipeline(cfg, device="cuda", local_ba_every=1, write_trajectory=False)
    nb = cfg.semantic.max_boxes

    def feed(t: int) -> None:
        left, right = src(t)
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
    busy = count = sgm = patches = 0.0
    for e in prof.key_averages():
        ms = (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)) / 1e3
        busy += ms
        count += e.count
        sgm += ms if "sgm_" in e.key else 0.0
        patches += ms if "extract_patches" in e.key else 0.0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "card": card, "frames": n,
        "host_ms_per_frame_median": float(np.median(wall)) * 1e3,
        "device_busy_ms_per_frame": busy / n,
        "device_busy_share_of_profiled_wall": busy / (prof_wall * 1e3),
        "device_ops_per_frame": count / n,
        "sgm_device_ms_per_frame": sgm / n,
        "patch_device_ms_per_frame": patches / n,
        "tracked": all(bool(o.pnp_ok) for o in pipe.outputs[1:]),
    }), flush=True)


if __name__ == "__main__":
    main()
