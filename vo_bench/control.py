"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 vo_bench/control.py --workload <cell> --seeds 1,2,... --seconds 3 \
        --control-seeds 7,8,9 --control-frames 12 [--out FILE]

On a card, in one process: the program's numbers (``vo_bench/check.py``)
from a short run of the cell on each of ``--seeds`` (the lower readings),
then the control's: the plain reference put in the program's place with
every float32 product in TF32, one precision step below the
configuration's float32, stepped over ``--control-frames`` frames of each
stream from frame 0, its frame 0 and ``check_samples`` frames (as many as
there are after the warm-up) drawn from the seed compared as a run compares the program's (the upper readings).
In a cell with a ``detector`` the control also runs the plain darknet
reference with TF32 on, one frame behind its tracker, on the weights that
a run of that seed makes, and its boxes and head maps are compared as the
program's are.
Prints one JSON line; ``--out`` writes it to a file too.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_samples(cell, seed: int, frames: int, device):
    """The TF32 reference as the program: -> (samples, scenes, the float32
    reference detector of the seed's weights, or None)."""
    import numpy as np
    import torch

    from vo_bench import check, darknet_weights
    from vo_bench.reference.config import VOConfig as RefConfig
    from vo_bench.reference.detector import Detector
    from vo_bench.scene import Scene, rng

    vo, traffic = cell.config["vo_config"], cell.traffic
    cam = vo["camera"]
    cfg = RefConfig.from_dict(vo)
    every = cell.config["pipeline"]["local_ba_every"] if traffic["driver"] == "pipeline" else 0
    W = vo["window"]["window_frames"]
    scenes = [Scene(traffic["scene"], seed, b, cam["height"], cam["width"], cam["fps"], vo["semantic"]["max_boxes"])
              for b in range(traffic["streams"])]
    first = int(traffic["warmup_frames"])
    picks = rng(seed, 2).choice(np.arange(first, frames), min(int(traffic["check_samples"]), frames - first),
                                replace=False)
    chosen = {0, *picks.tolist()}
    det = cell.config.get("detector")
    detector = None
    if det is not None:
        blob = darknet_weights.blob(det["cfg_text"], seed, det, scenes[0].frame(0).left, device)
        detector = Detector(det["cfg_text"], blob, det["conf_threshold"], det["nms_iou"], det["max_boxes"], device)
    n_boxes = vo["semantic"]["max_boxes"]
    samples = []
    for b, scene in enumerate(scenes):
        state = last = None   # last: the TF32 detection of the frame before
        for t in range(frames):
            kind = "init" if t == 0 else "track"
            refine = every > 0 and t % every == 0 and t + 1 >= W
            frame, heads = scene.frame(t), None
            if detector is not None:
                boxes, valid = np.zeros((n_boxes, 4), np.float32), np.zeros(n_boxes, bool)
                if last is not None:
                    m = min(n_boxes, len(last.valid))
                    boxes[:m], valid[:m] = last.boxes[:m], last.valid[:m]
                    heads = tuple(h.cpu().numpy() for h in last.heads)
                frame = frame._replace(boxes=boxes, boxes_valid=valid)
                last = detector.detect(torch.from_numpy(frame.left).to(device) / 255.0, tf32=True)
            after, T_wc = check.reference_step(cfg, state, frame, kind, refine, device, tf32=True)
            after = tuple(after)
            if t in chosen:
                samples.append(check.Sample(b, t, kind, refine, state, after, T_wc.double().cpu().numpy(),
                                            frame.boxes, frame.boxes_valid, None if heads is None else t - 1, heads))
            state = after
    return samples, scenes, detector


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of the program and of the control for one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-frames", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from vo_bench import check
    from vo_bench.bench import find_cell, measure

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cell = find_cell(args.workload, ROOT)
    out = {"workload": args.workload, "program": [], "control": []}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        res = measure(cell, seed, args.seconds, False, args.device, time.perf_counter())
        row = {"seed": seed, **{k: v["value"] for k, v in res["compared"].items()}, **res["read"],
               "failed": res["failed"], "attempted": res["attempted"]}
        out["program"].append(row)
        print(f"control: program seed {seed}: {row}", file=sys.stderr, flush=True)
        gc.collect()
    dev = torch.device(args.device)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        samples, scenes, detector = control_samples(cell, seed, args.control_frames, dev)
        nums = check.check_samples(samples, lambda b, t: scenes[b].frame(t), cell.config["vo_config"], dev,
                                   detector=detector)
        row = {"seed": seed, **nums, "samples": len(samples), "seconds": time.perf_counter() - t0}
        out["control"].append(row)
        print(f"control: control seed {seed}: {row}", file=sys.stderr, flush=True)
    for side in ("program", "control"):
        if out[side]:
            keys = [k for k in out[side][0] if k not in ("seed", "samples", "seconds", "failed", "attempted")]
            out[side + "_max"] = {k: max(r[k] for r in out[side]) for k in keys}
            out[side + "_min"] = {k: min(r[k] for r in out[side]) for k in keys}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
