"""Close the detector loop on the card: train the zoo tiny-v2 replica on
replay frames until it detects, then let its detections drive culling.

Port of the repository's ``tools/train_replay_detector.py``:

1. render replay frames with procedural "vehicle" billboards and exact
   projected ground-truth boxes (tests/kitti_replay.py's compositor);
2. train the zoo ``kitti_tiny_v2`` replica (models/yolo_train.YoloTrainer:
   darknet's region assignment, live BN, SGD with momentum and decay) on
   the rendered frames, augmented by models/augment (data.c semantics);
3. evaluate the trained detector on held-out frames: recall / IoU at the
   online pipeline's conf 0.8 operating point (semantic.cc:31);
4. run the online replay where the learned detections drive
   dynamic-object culling, and compare ATE against culling off.

    python3 -m stereo_semantic_vo_tpu_torch.tools.train_replay_detector [--device cuda] [--out DIR] [--steps N]

Writes ``<out>/detector_training.json`` with every number, the trained
``<out>/replay_tiny_v2.weights`` and the rendered frames'
``<out>/replay_det_cache.npz`` (``--out`` defaults to
``out/train_replay_detector``, which git ignores).  The render needs the
KITTI-01 ground-truth poses and the libelas urban images that
tests/kitti_replay.py and tests/fixtures_io.py read; the repository does
not ship them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_GT = 55          # GT poses -> 2x interpolated frames
BATCH = 8
STEPS = 1300
MAX_T = 8          # truth slots per image
# LR at batch-8 scale: 0.0012 diverged to NaN within 100 steps (region loss
# on 352px inputs); 3e-4 with a 100-step burn-in ramp is stable
TRAIN_LINES = ("momentum=0.9\ndecay=0.0005\nlearning_rate=0.0003\n"
               "burn_in=100\npolicy=steps\nsteps=900\nscales=.2")


def train_cfg(cfg_text: str) -> str:
    """A zoo cfg with the tool's training lines in its [net] section."""
    return cfg_text.replace("channels=3", "channels=3\n" + TRAIN_LINES, 1)


def build_replay(cache: str):
    """-> (poses, ReplayFrames), rendered once and cached at ``cache``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from kitti_replay import (
        ReplayFrames, build_corridor, interpolate_poses, lateral_crossing, load_kitti_gt,
        make_vehicle_billboard, render_replay,
    )

    if os.path.exists(cache):
        d = np.load(cache)
        rf = ReplayFrames(
            lefts=d["lefts"], rights=d["rights"], dyn_lefts=d["dyn_lefts"],
            dyn_rights=d["dyn_rights"], boxes=d["boxes"], boxes_valid=d["boxes_valid"],
        )
        return d["poses"], rf

    gt = load_kitti_gt(n=N_GT)
    poses = interpolate_poses(gt, 2)
    chunks = build_corridor(load_kitti_gt(n=N_GT + 40))
    # six staggered crossings so most frames carry 1-3 "vehicles", each a
    # procedural car-gestalt billboard (texture crops of the background
    # imagery are unlearnable)
    objects = [
        make_vehicle_billboard((5.0, 2.2), 1, lateral_crossing(poses, 6, 20.0, -6.0, 0.18, -1.0)),
        make_vehicle_billboard((4.2, 1.9), 2, lateral_crossing(poses, 25, 16.0, 7.0, -0.16, -0.9)),
        make_vehicle_billboard((4.6, 2.0), 3, lateral_crossing(poses, 45, 18.0, -7.0, 0.17, -0.9)),
        make_vehicle_billboard((4.4, 1.9), 4, lateral_crossing(poses, 62, 15.0, 6.5, -0.15, -1.0)),
        make_vehicle_billboard((4.8, 2.1), 5, lateral_crossing(poses, 80, 19.0, -6.5, 0.16, -0.9)),
        make_vehicle_billboard((4.0, 1.8), 6, lateral_crossing(poses, 95, 14.0, 6.0, -0.14, -0.8)),
    ]
    rf = render_replay(poses, chunks, objects=objects)
    np.savez(
        cache, poses=poses, lefts=rf.lefts, rights=rf.rights, dyn_lefts=rf.dyn_lefts,
        dyn_rights=rf.dyn_rights, boxes=rf.boxes, boxes_valid=rf.boxes_valid,
    )
    return poses, rf


def to_net(img_gray, net_w: int, net_h: int) -> np.ndarray:
    """(H, W) grayscale in [0, 255] -> letterboxed (net_h, net_w, 3) float32
    in [0, 1]: the inference preprocessing (models/yolo.letterbox), on the
    host CPU."""
    from stereo_semantic_vo_tpu_torch.models.yolo import letterbox

    H, W = img_gray.shape
    x = torch.from_numpy(np.asarray(img_gray, np.float32))[..., None] / 255.0
    x = x.expand(H, W, 3)
    return letterbox(x, net_w, net_h, W, H).contiguous().numpy()


def boxes_to_truths(boxes, valid, img_w, img_h, net_w, net_h):
    """GT pixel boxes (x1y1x2y2) -> (MAX_T, 5) letterboxed-relative cxcywh
    truths + mask (matches unletterbox_boxes' geometry)."""
    scale = min(net_w / img_w, net_h / img_h)
    ox = (net_w - img_w * scale) / 2.0
    oy = (net_h - img_h * scale) / 2.0
    t = np.zeros((MAX_T, 5), np.float32)
    m = np.zeros((MAX_T,), bool)
    j = 0
    for b, v in zip(boxes, valid):
        if not v or j >= MAX_T:
            continue
        x1, y1, x2, y2 = b
        cx = (ox + (x1 + x2) / 2.0 * scale) / net_w
        cy = (oy + (y1 + y2) / 2.0 * scale) / net_h
        w = (x2 - x1) * scale / net_w
        h = (y2 - y1) * scale / net_h
        if w <= 0.01 or h <= 0.01:
            continue
        t[j] = (cx, cy, w, h, 0)
        m[j] = True
        j += 1
    return t, m


def iou_xyxy(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def main(argv: list[str] | None = None) -> None:
    from stereo_semantic_vo_tpu_torch.core.config import VOConfig
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
    from stereo_semantic_vo_tpu_torch.eval.ate import ate_rmse
    from stereo_semantic_vo_tpu_torch.models import yolo, yolo_train, zoo
    from stereo_semantic_vo_tpu_torch.models.augment import augment_batch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "train_replay_detector"))
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_replay_detector: --device cuda but no CUDA card; pass --device cpu")
    os.makedirs(args.out, exist_ok=True)

    t0 = time.time()
    poses, rf = build_replay(os.path.join(args.out, "replay_det_cache.npz"))
    print(f"rendered {len(poses)} frames in {time.time() - t0:.0f}s", flush=True)

    cfg_text = train_cfg(zoo.KITTI_TINY_V2_CFG)
    net_w = net_h = 352
    H, W = rf.dyn_lefts[0].shape

    n = len(poses)
    imgs, truths, masks = [], [], []
    for t in range(n):
        imgs.append(to_net(rf.dyn_lefts[t], net_w, net_h))
        tt, mm = boxes_to_truths(rf.boxes[t], rf.boxes_valid[t], W, H, net_w, net_h)
        truths.append(tt)
        masks.append(mm)
    imgs_np, truths_np, masks_np = np.stack(imgs), np.stack(truths), np.stack(masks)
    # interleaved split: every 5th frame held out (same domain, unseen
    # frames; a tail split confounds generalization with scene drift)
    heldout_idx = [t for t in range(n) if t % 5 == 4]
    train_idx = np.array([t for t in range(n) if t % 5 != 4])
    n_train = len(train_idx)

    # darknet-style augmentation: two augmented epochs of the train split,
    # made once, so that batches index device-resident tensors.  Grayscale
    # world: exposure, crop and flip are the live parts.
    arng = np.random.RandomState(42)
    aug_imgs, aug_truths, aug_masks = [imgs_np[train_idx]], [truths_np[train_idx]], [masks_np[train_idx]]
    for _ in range(2):
        ai, at, am = augment_batch(
            imgs_np[train_idx], truths_np[train_idx], masks_np[train_idx], arng,
            jitter=0.15, hue=0.0, saturation=1.0, exposure=1.4,
        )
        aug_imgs.append(ai)
        aug_truths.append(at)
        aug_masks.append(am)
    train_imgs = torch.from_numpy(np.concatenate(aug_imgs)).to(dev)
    train_truths = torch.from_numpy(np.concatenate(aug_truths)).to(dev)
    train_masks = torch.from_numpy(np.concatenate(aug_masks)).to(dev)
    n_pool = train_imgs.shape[0]
    n_boxes_train = int(masks_np[train_idx].sum())
    print(f"{n_train} train frames (x3 augmented pool={n_pool}) / {len(heldout_idx)} held-out "
          f"(interleaved); {n_boxes_train} base training boxes", flush=True)

    trainer = yolo_train.YoloTrainer(cfg_text, seed=0, device=dev)
    rng = np.random.RandomState(0)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        idx = torch.from_numpy(rng.randint(0, n_pool, BATCH)).to(dev)
        loss, stats = trainer.train_step(
            train_imgs.index_select(0, idx), train_truths.index_select(0, idx), train_masks.index_select(0, idx)
        )
        losses.append(loss)
        if step % 100 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:9.3f} obj {float(stats.avg_obj):.3f} "
                  f"iou {float(stats.avg_iou):.3f}", flush=True)
    train_s = time.time() - t0

    with open(os.path.join(args.out, "replay_tiny_v2.weights"), "wb") as f:
        f.write(trainer.export_weights())

    # ---- held-out evaluation at the online operating point (conf 0.8)
    det = yolo.YoloDetector.from_params(cfg_text, trainer.folded_params(), conf_threshold=0.8, device=dev)
    tp = fp = fn = 0
    ious = []
    for t in heldout_idx:
        out = det.detect(torch.from_numpy(rf.dyn_lefts[t].astype(np.float32) / 255.0).to(dev))
        valid = out.valid.cpu().numpy()
        pred = [b for b, v in zip(out.boxes.cpu().numpy(), valid) if v]
        gtb = [rf.boxes[t][i] for i in range(rf.boxes.shape[1]) if rf.boxes_valid[t][i]]
        used = set()
        for g in gtb:
            best, bi = 0.0, None
            for i, p in enumerate(pred):
                if i in used:
                    continue
                v = iou_xyxy(g, p)
                if v > best:
                    best, bi = v, i
            if bi is not None and best >= 0.5:
                tp += 1
                used.add(bi)
                ious.append(best)
            else:
                fn += 1
        fp += len(pred) - len(used)
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    mean_iou = float(np.mean(ious)) if ious else 0.0
    print(f"held-out @conf0.8: recall {recall:.3f} precision {precision:.3f} "
          f"mean IoU {mean_iou:.3f} (tp={tp} fp={fp} fn={fn})", flush=True)

    # ---- online replay: learned detections drive culling
    base = VOConfig.kitti("00")
    vcfg = dataclasses.replace(
        base,
        orb=dataclasses.replace(base.orb, max_keypoints=1024),
        matcher=dataclasses.replace(base.matcher, local_map_ratio=1.2),
        window=dataclasses.replace(base.window, window_frames=8),
    )

    def run(detector):
        pipe = VOPipeline(vcfg, device=dev, detector=detector, out_dir=None, write_trajectory=False)
        for t in range(n):
            pipe.process_frame(rf.dyn_lefts[t].astype(np.float32), rf.dyn_rights[t].astype(np.float32),
                               None, None, t * 0.05)
        pipe.flush()
        est = np.stack([o.T_wc.cpu().numpy().astype(np.float64) for o in pipe.outputs])
        culled = sum(int(o.n_culled_dynamic) for o in pipe.outputs)
        return ate_rmse(est, poses[:n], align=False), culled

    ate_learned, culled_learned = run(det)
    ate_off, _ = run(None)
    path = float(np.sum(np.linalg.norm(np.diff(poses[:n, :3, 3], axis=0), axis=1)))
    print(f"online replay: ATE learned-culling {ate_learned:.2f} m ({100 * ate_learned / path:.1f}%) vs "
          f"culling-off {ate_off:.2f} m ({100 * ate_off / path:.1f}%), culled={culled_learned}", flush=True)

    out = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "frames": n, "train_frames": n_train, "train_boxes": n_boxes_train,
        "steps": args.steps, "batch": BATCH, "train_seconds": round(train_s, 1),
        "loss_first": round(float(np.mean(losses[:10])), 3),
        "loss_last": round(float(np.mean(losses[-10:])), 3),
        "heldout_conf08": {
            "recall": round(recall, 3), "precision": round(precision, 3),
            "mean_iou": round(mean_iou, 3), "tp": tp, "fp": fp, "fn": fn,
        },
        "online_replay": {
            "ate_learned_culling_m": round(ate_learned, 2),
            "ate_no_culling_m": round(ate_off, 2),
            "path_m": round(path, 1),
            "n_culled": culled_learned,
        },
    }
    path_json = os.path.join(args.out, "detector_training.json")
    with open(path_json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path_json}")


if __name__ == "__main__":
    main()
