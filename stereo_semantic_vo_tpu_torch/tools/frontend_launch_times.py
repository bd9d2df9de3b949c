"""Time kernels B4 (FAST scores), B3 (the fused matcher), B2 (the
per-keypoint stereo stage) and B8 (the Hamming matrix) of this tree
against those of another checkout of the port, on one CUDA card, at the
shapes the tracking paths give them.

    python3 -m stereo_semantic_vo_tpu_torch.tools.frontend_launch_times --parent DIR [--out PATH]

from the root of the repository (it takes its helpers from
``chip_smoke.py`` and ``tools/ba_launch_times.py``).  DIR holds an older
``stereo_semantic_vo_tpu_torch/`` (for example a ``git archive`` of the
parent commit, unpacked); each tree is imported from its own files and
builds its kernels from its own sources.  The script reports, with CUDA
events (median of ``--reps`` calls), in turns older, this, this, older:

- B4: a frame's 8 ``kitti()`` levels at both thresholds with
  ``extract_orb``'s border mask and 3x3 NMS.  The older tree runs them as
  its ``extract_orb`` does, if it has no ``fast_scores_levels``: a
  ``fast_scores`` call a level, then the mask and ``_nms3`` on each map.
  This tree makes its one fused call;
- B3: a tracking step's two matcher calls (Q=2048 and Q=512 against
  T=512);
- B2: ``ops.stereo.sparse_disparity`` in mode "pallas" on a frame's K=512
  keypoints (``chip_smoke.stereo_inputs``): whatever each tree runs for
  it, the kernel and the PyTorch ops around it;
- B8: the Hamming matrices of B3's two shapes;

then each one's device time (``torch.profiler``: every kernel, copy and
fill the work puts on the device).  It checks that the two trees give
equal maps, matches, stereo outputs and matrices.  One JSON line goes to stdout and, with ``--out PATH``, to that
file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import device_ms, median_ms, stereo_inputs
from stereo_semantic_vo_tpu_torch.core.camera import Camera
from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
from stereo_semantic_vo_tpu_torch.kernels import fast_score, hamming, matcher
from stereo_semantic_vo_tpu_torch.ops import stereo
from stereo_semantic_vo_tpu_torch.ops.orb import pyramid
from stereo_semantic_vo_tpu_torch.tools.ba_launch_times import load_parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout holding the older stereo_semantic_vo_tpu_torch/")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frontend_launch_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    old, _ = load_parent(args.parent, ("kernels.fast_score", "kernels.matcher", "ops.orb", "ops.stereo",
                                       "kernels.hamming"))
    pf, pm, porb = old["kernels.fast_score"], old["kernels.matcher"], old["ops.orb"]
    pst, ph = old["ops.stereo"], old["kernels.hamming"]
    cfg = VOConfig.kitti("00")
    oc, reps = cfg.orb, args.reps

    # B4 on a frame's 8 levels
    levels = pyramid(torch.from_numpy(two_plane_frame_source(cfg.camera.height, cfg.camera.width)(3)[0]).to(dev), oc)
    ths, b = (float(oc.fast_threshold), float(oc.fast_min_threshold)), oc.border

    def parent_fast():
        if hasattr(pf, "fast_scores_levels"):
            return pf.fast_scores_levels(levels, ths, b)
        maps = []
        for img in levels:  # the older extract_orb's per-level loop
            H, W = img.shape
            level = []
            for sc in pf.fast_scores(img, ths):
                inner = torch.zeros_like(sc)
                inner[b : H - b, b : W - b] = sc[b : H - b, b : W - b]
                level.append(porb._nms3(inner))
            maps.append(level)
        return maps

    def this_fast():
        return fast_score.fast_scores_levels(levels, ths, b)

    # B3: a step's two calls
    rng = np.random.RandomState(0)
    T = oc.max_keypoints
    calls = []
    for Q in (cfg.window.max_map_points, oc.max_keypoints):
        q = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
        t = rng.randint(0, 2**32, (T, 8), dtype=np.uint64).astype(np.uint32)
        q[:16] = t[100:116]
        calls.append([torch.from_numpy(a.view(np.int32)).to(dev) for a in (q, t)]
                     + [torch.from_numpy(rng.rand(n) > 0.2).to(dev) for n in (Q, T)])

    def parent_match():
        return [pm.fused_best_match(*c) for c in calls]

    def this_match():
        return [matcher.fused_best_match(*c) for c in calls]

    # B2: the per-keypoint stereo stage of a frame, sparse_disparity in mode "pallas"
    left, right, uv, kp_valid = stereo_inputs(cfg, dev, rng)
    cam = Camera.from_config(cfg.camera, dev)
    sc = dataclasses.replace(cfg.stereo, sparse_mode="pallas")

    def parent_stereo():
        return pst.sparse_disparity(left, right, uv, kp_valid, cam, sc)

    def this_stereo():
        return stereo.sparse_disparity(left, right, uv, kp_valid, cam, sc)

    # B8: the two Hamming matrices of the matcher's shapes
    def parent_hamming():
        return [ph.hamming_distance_matrix_pallas(c[0], c[1]) for c in calls]

    def this_hamming():
        return [hamming.hamming_distance_matrix_pallas(c[0], c[1]) for c in calls]

    pa, th = parent_fast(), this_fast()
    pma, tma = parent_match(), this_match()
    torch.cuda.synchronize()
    agree = {
        "fast_maps": all(torch.equal(x, y) for a, c in zip(pa, th) for x, y in zip(a, c)),
        "matches": all(torch.equal(x, y) for a, c in zip(pma, tma) for x, y in zip(a, c)),
        "stereo": all(torch.equal(x, y) for x, y in zip(parent_stereo(), this_stereo())),
        "hamming": all(torch.equal(x, y) for x, y in zip(parent_hamming(), this_hamming())),
    }
    work = {"fast_frame": (parent_fast, this_fast), "match_step": (parent_match, this_match),
            "stereo_stage": (parent_stereo, this_stereo), "hamming_matrix": (parent_hamming, this_hamming)}
    turns = {f"{name}{suffix}": [] for name in work for suffix in ("_parent_ms", "_ms")}
    for order in (("parent", "this"), ("this", "parent")):
        for who in order:
            for name, (f_old, f_new) in work.items():
                turns[name + ("_parent_ms" if who == "parent" else "_ms")].append(
                    median_ms(f_old if who == "parent" else f_new, reps=reps, warmup=5))
    res = {"card": card, "agree": agree, "reps": reps, "turns": turns,
           "device_ms": {f"{name}{suffix}": device_ms(fn, ()) for name, fns in work.items()
                         for suffix, fn in zip(("_parent", ""), fns)}}
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    if not all(agree.values()):
        raise SystemExit("frontend_launch_times: the trees disagree")


if __name__ == "__main__":
    sys.exit(main())
