"""CLI driver for the PyTorch port, with the flags of
``python -m stereo_semantic_vo_tpu.run``.

Examples:
  # offline semantic boxes (the reference's shipped mode)
  python -m stereo_semantic_vo_tpu_torch.run --sequence /data/kitti/odometry/01 \
      --seq-id 01 --boxes-dir /data/boxes/0.05results --out out/

  # online YOLO detection, one frame late on a side CUDA stream
  python -m stereo_semantic_vo_tpu_torch.run --sequence ... --yolo-cfg yolov2-tiny.cfg \
      --yolo-weights yolov2-tiny.weights

``--device`` (default ``cuda``) picks where it runs, as ``JAX_PLATFORMS``
does for the reference; without a CUDA device ``--device cuda`` exits with
an error.  ``--dense-stereo`` samples the dense SGM disparity at the
keypoints and ``--local-ba N`` refines the 4-frame window every N frames;
on a CUDA device both run on the package's kernels.  ``--yolo-cfg``
detects online with a darknet cfg (models/yolo.YoloDetector) on the same
device, at ``cfg.semantic``'s threshold, NMS IoU and box count, with the
weights of ``--yolo-weights`` or, without them, random weights; the
detections replace the offline boxes.  On a CUDA device each frame
replays CUDA graphs of the step (engine/graphs.py), as the reference's
jitted step runs; the CPU dispatches eagerly.

The report printed last (JSON) holds the reference's keys (``n_frames``,
the frame times, ``ate_rmse_m`` with ``--gt``) and the device, the points
culled as dynamic at each frame, each CUDA kernel's launches in the run
(all 0 on the CPU, which runs the kernels' plain versions) and
``stage_device_ms``, each stage's mean device ms a frame from the tracer's
stamps (utils/profiling.py; on the CPU its host clock).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch


def main() -> None:
    p = argparse.ArgumentParser(description="Stereo semantic VO (PyTorch port)")
    p.add_argument("--sequence", required=True, help="KITTI sequence dir (times.txt, image_2/, image_3/)")
    p.add_argument("--seq-id", default="00", help="KITTI sequence id for intrinsics (00..12)")
    p.add_argument("--boxes-dir", default=None, help="offline YOLO box files dir (<frame+1>.txt)")
    p.add_argument("--yolo-cfg", default=None, help="darknet cfg for online detection")
    p.add_argument("--yolo-weights", default=None, help="darknet .weights for online detection")
    p.add_argument("--out", default="out", help="output dir for trajectories")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--no-semantics", action="store_true")
    p.add_argument("--gt", default=None, help="KITTI GT pose file for ATE report")
    p.add_argument("--local-ba", type=int, default=0, metavar="N",
                   help="run windowed local BA every N frames (0 = off)")
    p.add_argument("--dense-stereo", action="store_true",
                   help="reference-faithful dense SGM disparity sampled at keypoints")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the first CUDA device (default) or on the CPU")
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")

    from stereo_semantic_vo_tpu_torch.core.config import VOConfig
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
    from stereo_semantic_vo_tpu_torch.io import kitti
    from stereo_semantic_vo_tpu_torch.kernels import launch_counters
    from stereo_semantic_vo_tpu_torch.utils import profiling

    cfg = VOConfig.kitti(args.seq_id)
    if args.no_semantics:
        cfg = dataclasses.replace(cfg, use_semantics=False)
    if args.dense_stereo:
        cfg = dataclasses.replace(cfg, stereo=dataclasses.replace(cfg.stereo, sparse_mode="dense"))

    detector = None
    if args.yolo_cfg:
        from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector

        with open(args.yolo_cfg) as f:
            cfg_text = f.read()
        weights = None
        if args.yolo_weights:
            with open(args.yolo_weights, "rb") as f:
                weights = f.read()
        detector = YoloDetector(
            cfg_text,
            weights_bytes=weights,
            conf_threshold=cfg.semantic.online_conf_threshold,
            nms_iou=cfg.semantic.nms_iou,
            max_boxes=cfg.semantic.max_boxes,
            device=args.device,
        )

    paths = kitti.load_sequence_paths(args.sequence)
    frames = kitti.iter_frames(
        paths, args.boxes_dir, cfg.semantic.max_boxes, args.max_frames,
        image_hw=(cfg.camera.height, cfg.camera.width),
    )
    pipe = VOPipeline(cfg, device=args.device, detector=detector, out_dir=args.out, local_ba_every=args.local_ba)
    summary = pipe.run(frames)
    report = {k: v for k, v in summary.items() if k != "positions"}
    report["device"] = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    report["n_culled_dynamic"] = [int(o.n_culled_dynamic) for o in pipe.outputs]
    report["kernel_launches"] = {name: entry.launches for name, entry in launch_counters().items()}
    # each stage's mean device ms a frame, from the step graphs' stamps
    trace = profiling.collect(pipe.steps.rings.values())
    report["stage_device_ms"] = trace.stage_ms_per_frame(summary["n_frames"])

    if args.gt:
        from stereo_semantic_vo_tpu_torch.engine.trajectory import load_kitti_poses
        from stereo_semantic_vo_tpu_torch.eval.ate import ate_rmse

        gt = load_kitti_poses(args.gt)[: summary["n_frames"]]
        est = load_kitti_poses(f"{args.out}/cameratrajectory_kitti.txt")
        report["ate_rmse_m"] = ate_rmse(est, gt)

    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
