"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. build the CUDA kernels of ``stereo_semantic_vo_tpu_torch/csrc`` with nvcc;
2. compare each kernel with its plain PyTorch version on the card, at the
   shapes the KITTI paths give it, and time both with CUDA events, the
   kernel also alone on the device (``torch.profiler``);
3. run ``VOPipeline(VOConfig.kitti("00"), device="cuda")`` on a procedural
   1241x376 two-plane sequence with exact ground truth, and check poses,
   tracking and that every kernel launched as often as the path calls it;
4. run the first frames again on the CPU (plain versions) and compare poses;
5. report the steady-state time per frame;
6. the same for the second path, dense stereo with window BA
   (``sparse_mode="dense"``, ``local_ba_every=1``, as
   ``run.py --dense-stereo --local-ba 1`` drives it): ground truth, exact
   launch counts, no host sync in a dense ``track_step`` or in
   ``refine_state``, a CPU rerun and the steady-state time per frame;
7. the same for the third path, the tracking step with its two kernel knobs
   on (``orb.fast_backend="pallas"``, ``ba.hessian_backend="pallas"``):
   ground truth, exact launch counts, its poses against the first path's,
   no host sync in a ``track_step``, a CPU rerun and the steady-state time
   per frame;
8. the online detector (``zoo.kitti_tiny_v2`` with random weights from
   seed 0) on frame 0 of the scene on the card against the CPU, timed
   beside its bound, without a host sync;
9. the fourth path, online detection (``VOPipeline(detector=...,
   async_detect=True)``, as ``run.py --yolo-cfg`` drives it): detection of
   frame t on a side CUDA stream beside ``track_step(t)``, its boxes used by
   frame t+1.  Ground truth, the sparse path's launch counts, valid boxes
   and culled points per frame, its poses against the sparse path fed its
   own detections one frame late as offline boxes, no host sync in a
   ``track_step`` with pending detections or in a frame's dispatch, a CPU
   rerun with the detector on the CPU, the steady-state time per frame and
   whether the side stream's kernels overlap the step's in one profiled
   frame;
10. the fifth path, steered BRIEF (``VOConfig.kitti("00")`` with
   ``orb.steer=True``, the JAX package's default descriptor): ground truth,
   exact launch counts, no host sync in a ``track_step``, a CPU rerun and
   the steady-state time per frame beside the sparse path's;
11. the whole-image stereo modes "volume" and "volume2" on a frame's 512
   ORB keypoints against "strips" and B2, timed, with the kernels a
   "volume" call launches;
12. the data-parallel tracker (``parallel/dp_tracker``) at B = 1, 2 and 4
   streams on the card, each on its own CUDA stream, on offset copies of
   the scene with staggered starts, eager and replaying each stream's
   CUDA graphs in turns (eager, graph, eager, graph): in each run exact
   launch counts, ground truth, every stream bit for bit its own
   single-stream run, no host sync in a step, frames/s, ms a step, the
   device's idle share and kernels a step; under graphs the capture ms and
   graph pool of a stream;
13. the landmark-sharded window BA over NCCL at world size 1, in this
   process: the solver against ``ops/local_ba.local_ba`` (F=4, L=2048,
   stereo edges) and ``VOPipeline(ba_mesh=..., local_ba_every=1)``
   against the pipeline without a mesh, no host sync in a sharded refine;
   then the solver and the mesh pipeline eager and replaying their CUDA
   graphs (the NCCL collectives captured inside) in turns (eager, graph,
   eager, graph): each graph run bit for bit the eager runs, the refine
   graph's replays counted, no host sync in a replay, ms a solve and a
   refine in each mode, kernels a solve and a refine, capture ms and pool
   MiB;
14. the replicated detector (``parallel/semantic_head``, one batched
   program a device, a CUDA graph on the card): a replayed batch of two
   frames against ``YoloDetector.detect`` of each; batches of 2 and 4
   frames eager and replaying in turns, bit for bit, no host sync in a
   replay, ms and kernels a batch in each mode, capture ms and pool MiB;
15. detector training at full width: ``models/yolo_train.YoloTrainer`` on
   ``zoo.KITTI_TINY_V2_CFG`` with the replay-training tool's training lines
   (352x352, 8 images a step, 8 truth slots; smoke frames letterboxed by the
   tool's ``to_net``, truths from their boxes through ``boxes_to_truths``):
   20 steps on the card, eager and replaying the step's CUDA graph in
   turns (eager, graph, eager, graph, eager, eager), the loss finite at
   each, the counters, each graph run as close to an eager run as the
   eager runs come to each other (bit for bit where they are), the first
   graph run's first 2 steps against the CPU
   (loss and every param, statistic and momentum buffer), no host sync in
   a step's dispatch, the exported weights against the folded params in
   ``YoloDetector``; then 5 steps of ``zoo.TINY_V3_CFG`` (the yolo-loss
   heads) at 416x416 the same way, one against the CPU.  Each run prints
   ms a step, images/s, kernels a step, the device's busy share of a
   profiled step and its conv FLOPs' share of the float32 peak;
16. checkpoint and resume on the card: the sparse path for 10 frames,
   ``utils/checkpoint.save_state``, ``load_state`` into a fresh pipeline
   that tracks frames 10-19, bit for bit the first path's poses; one frame
   under ``utils/profiling.device_trace`` writes a trace;
17. the native frame loader (``io/native_loader``): whether it builds on
   this machine and why not; where it does, PNGs of the scene decoded equal
   to Pillow and ``io/kitti.iter_frames(..., image_hw=...)`` in order;
   where it does not, ``iter_frames`` on Pillow;
18. the reference's shipped mode through ``run.py``: 30 frames of the scene
   with a moving object (``mover_frames``: a textured square moving down,
   its box missed on every fifth frame) written as a KITTI directory with
   the reference's box files and a ground-truth pose file, then
   ``python -m stereo_semantic_vo_tpu_torch.run`` in a subprocess with the
   default device, four times: offline boxes, ``--no-semantics`` (30
   frames each, ``--gt``), ``--dense-stereo --local-ba 1`` and
   ``--yolo-cfg`` (8 frames each).  Each exits 0 on the card with the
   launch counts of its path (from its report) and poses within the
   ground-truth bounds; the offline and ``--no-semantics`` trajectory
   files are byte for byte those of ``VOPipeline`` on ``kitti.iter_frames``
   of the same directory in this process; the offline run culls points in
   the frames after a missed box and ``--no-semantics`` none; 8 frames of
   the offline configuration on the host CPU agree in pose (their culled
   counts are printed beside the card's); an offline-box ``track_step``
   after a miss does not sync;
19. CUDA graphs: every path above (its ``VOPipeline`` replays captured
   graphs of ``init_step`` / ``track_step``, ``refine_state`` and, online,
   ``detect`` on the card, as in phases 3-18) and the same pipeline with
   ``capture=False`` run in turns, eager, graph, eager, graph: sparse, knob
   and steered over 30 frames, dense with window BA every frame and online
   over 8.  Each graph run equals the eager runs bit for bit (every output
   of every frame and the final ``VOState``) with the same launch counts;
   each turn's median and p90 host ms/frame, the graphs' capture ms and
   pool MiB, three profiled frames of each kind (device busy ms, idle
   share, kernels a frame; frame t-1's readback waits on its own event,
   so the host queues frame t+1 while the device runs frame t) and a
   replaying frame under sync debug mode.

Each kernel's line entry carries its time and its plain version's (CUDA
events, wrapper included; for the two BA builds beside ``step_ms``, a
step of the build an LM loop binds once; for B2 beside ``stage_*``, the
fused per-keypoint step the paths run), its
device time alone (``device_ms``: the profiler's durations of its CUDA
kernels), the least time the card could take for the same work (``bound_ms``:
the bytes it must move at 3.35 TB/s or its operations at the card's peak
rate for their type, whichever is larger, from this run's shapes) and, where
one PyTorch call computes the same function, that call's time
(``library_ms``; the port never calls it).

``launches_by_path`` holds each path's count, the CLI runs' (``cli_*``)
included; ``launches`` is their sum.

Prints the card (``nvidia-smi``), one JSON line with the kernels, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with an error before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES = 30        # GPU run of the slice
N_CPU_FRAMES = 8     # CPU rerun of the first frames
N_DENSE_FRAMES = 30  # GPU run of the dense + window-BA path
N_DENSE_CPU_FRAMES = 5  # its CPU rerun: frames 3 and 4 refine the window
N_KNOB_FRAMES = 30   # GPU run of the knob path
N_KNOB_CPU_FRAMES = 8
POS_BOUND_M = 0.1    # per-frame camera position error against ground truth
ROT_BOUND_RAD = 0.01  # per-frame rotation error against ground truth (identity)
CPU_POS_TOL_M = 1e-3  # GPU vs CPU pose agreement (the slice parity tolerance)
CPU_ROT_TOL_RAD = 1e-3
BA_RTOL, BA_ATOL_REL, BA_COST_RTOL = 3e-5, 1e-4, 1e-5  # tests/test_ba_hessian.py's bounds
MH_RTOL, MH_ATOL_REL, MH_COST_RTOL = 2e-5, 1e-6, 1e-5  # its motion-build bounds
PATH_POS_TOL_M = 1e-3  # knob path vs first path: B4 is bit-equal, B5 sums in another order
PATH_ROT_TOL_RAD = 1e-3
N_ONLINE_FRAMES = 30  # GPU run of the online-detection path
N_ONLINE_CPU_FRAMES = 5
DET_RTOL, DET_ATOL_REL = 1e-4, 1e-4  # detector head maps, card vs CPU (cuDNN vs CPU convolutions, TF32 off)
DET_BOX_TOL_PX = 1e-2                 # detected boxes, card vs CPU, where valid
REPLAY_POS_TOL_M = 1e-6  # online path vs its detections replayed one frame late: expected bit for bit
REPLAY_ROT_TOL_RAD = 1e-6
N_STEER_FRAMES = 30   # GPU run of the steered path
N_STEER_CPU_FRAMES = 5
VOLUME_DISP_TOL_PX = 1e-4  # volume modes vs strips / B2 where the strip is not clamped
VOLUME_COST_RTOL = 1e-5    # ... and their costs where it is (strips reads disparity d at d - shift)
N_DP_STEPS = 12       # steps of the data-parallel tracker at each B
DP_TIMED_FROM = 4     # steps before it warm up (and hold the staggered starts)
DP_OFFSET = 2         # stream b sees the scene's frame t + 2b
DP_BATCHES = (1, 2, 4)
SHARDED_COST_RTOL, SHARDED_POSE_ATOL, SHARDED_POINT_MEDIAN_M = 1e-3, 5e-3, 0.05  # tests/test_sharded_ba.py:51-55
N_SHARDED_FRAMES = 8  # the pipeline with a mesh, window BA every frame from frame 3
N_TRAIN_STEPS = 20    # kitti_tiny_v2 training steps on the card, batch TRAIN_BATCH
TRAIN_TIMED_FROM = 5  # its ms a step: CUDA-event median over steps 5-19
N_TRAIN_CPU_STEPS = 2  # the first steps again on the host CPU
N_V3_STEPS = 5        # tiny_v3 (the yolo-loss heads) steps on the card
N_V3_CPU_STEPS = 1
TRAIN_START_BEFORE = 3  # every run starts 3 steps short of the end of the lr burn-in and of 12800 images seen
N_DET_TRAIN_STEPS = 6   # steps of the eager and graph runs under cuDNN's deterministic algorithms
TRAIN_BATCH = 8       # images a step, as the replay-training tool feeds them ([net] batch stays 1)
N_TRAIN_POOL = 16     # letterboxed smoke frames the batches cycle through
# card vs CPU at full width: the loss rtol 1e-5; each param, statistic and
# momentum buffer within 1.5e-2 of its L2 norm.  Float32 is not exact here:
# the BN sums run over 8 x 352 x 352 pixels, and on two letterboxed smoke
# frames the CPU's float32 gradients of kitti_tiny_v2 lie 4.0e-3 of a
# leaf's norm from float64's (tests/test_torch_yolo_train_steps.py holds
# them under half this bound)
TRAIN_LOSS_RTOL, TRAIN_LEAF_L2_RTOL = 1e-5, 1.5e-2
N_RESUME_AT, N_RESUME_FRAMES = 10, 20  # checkpoint after frame 9, resume on frames 10-19
N_CLI_FRAMES = 30        # run.py with offline boxes and with --no-semantics, on the mover scene
N_CLI_SHORT_FRAMES = 8   # run.py --dense-stereo --local-ba 1 and --yolo-cfg
N_CLI_CPU_FRAMES = 8     # the offline configuration again on the host CPU
N_GRAPH_FRAMES = 30      # phase 19: eager and graph runs of the sparse, knob and steered paths
N_GRAPH_SHORT_FRAMES = 8  # ... and of the dense (window BA every frame) and online paths
CLI_TIMEOUT_S = 300
ATE_BOUND_M = 0.1        # run.py's ate_rmse_m against the ground-truth file
MOVER_PX = 120           # the moving object's side
MOVER_X, MOVER_Y0, MOVER_VY_PX = 560, 16, 8  # its left edge, first top edge and px a frame downward
MOVER_MISS_EVERY = 5     # its box is missed on frames t % 5 == 0
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
POPC_PER_CLOCK_PER_SM = 16


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def popc_per_s() -> float:
    """Peak popcounts a second: 16 a clock per SM at the card's top SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def bound(nbytes: float, ops: float, op_rate: float = FP32_FLOP_PER_S) -> dict:
    """The least time the card could take: bytes moved once at the HBM rate
    or the operations at their peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median over ``reps`` calls of the device time of ``fn()`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, names: tuple[str, ...], reps: int = 20, only: bool = False) -> float:
    """Device time per call of ``fn()`` spent in the kernels whose names hold
    one of ``names``, or with ``names`` empty in every kernel, copy and fill
    it runs: their durations from ``torch.profiler`` (CUPTI), so without the
    wrapper's host time, which the CUDA-event median includes.  With
    ``only``, ``fn()`` must run nothing else on the device: one kernel of
    ``names`` a call, no other kernel, copy or fill."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then the profiler hands back an empty window: take another
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, seen = 0.0, set()
        if names:
            for e in prof.key_averages():
                hit = [n for n in names if n in e.key]
                if hit:
                    seen.update(hit)
                    total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        else:
            total = sum((getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0))
                        for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if seen == set(names) and total > 0:
            break
    check(seen == set(names) and total > 0, f"profiler saw {sorted(seen)} of the kernels {list(names)}")
    if only:  # the profiler may drop an event of the window, never add one
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        others = sorted({d for d in device if not any(n in d for n in names)})
        check(not others and 0 < len(device) <= reps,
              f"expected one kernel of {list(names)} a call, saw {len(device)} device events in {reps} calls "
              f"(others: {others})")
    return total / 1e3 / reps


def covered_pixels(H: int, W: int, y0: torch.Tensor, x0: torch.Tensor, h: int, w: int) -> int:
    """Pixels of an (H, W) image inside the union of the h x w windows at
    origins (y0, x0), columns wrapping at W: what a kernel that reads each
    of them once must read, however much the windows overlap."""
    dev = y0.device
    rows = y0.long()[:, None] + torch.arange(h, device=dev)
    cols = (x0.long()[:, None] + torch.arange(w, device=dev)) % W
    cover = torch.zeros((H, W), dtype=torch.bool, device=dev)
    cover[rows[:, :, None], cols[:, None, :]] = True
    return int(cover.sum())


def pyramid_shapes(cfg, H: int, W: int) -> list[tuple[int, int, int]]:
    """(H_l, W_l, K_l) of each pyramid level: image shape and patch count."""
    from stereo_semantic_vo_tpu_torch.ops.orb import _level_budgets

    out = []
    budgets = _level_budgets(cfg, 2 * cfg.max_keypoints)
    cells = cfg.grid_rows * cfg.grid_cols
    for level in range(cfg.n_levels):
        out.append((H, W, cells * max(1, math.ceil(budgets[level] / cells))))
        H = max(int(round(H / cfg.scale_factor)), 32)
        W = max(int(round(W / cfg.scale_factor)), 32)
    return out


def compare_patches(cfg, dev, rng) -> dict:
    """B1: one call for a frame's 8 levels against its plain version and
    against 8 ``unfold`` gathers, bit-equal at every level shape."""
    from stereo_semantic_vo_tpu_torch.kernels.patch_extract import (
        extract_patches_levels,
        extract_patches_levels_plain,
    )

    r = cfg.orb.patch_size // 2
    P = 2 * r + 1
    imgs, ys, xs, counts, gathers, nbytes = [], [], [], [], [], 0.0
    for H, W, K in pyramid_shapes(cfg.orb, cfg.camera.height, cfg.camera.width):
        img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
        y0 = torch.from_numpy(rng.randint(0, H - P + 1, K).astype(np.int32)).to(dev)
        x0 = torch.from_numpy(rng.randint(0, W - P + 1, K).astype(np.int32)).to(dev)
        y0[:2], x0[:2] = torch.tensor([0, H - P]), torch.tensor([W - P, 0])  # corners
        imgs.append(img)
        ys.append(y0)
        xs.append(x0)
        counts.append(K)
        # the library yardstick: one gather from the image's (H-P+1, W-P+1, P, P) window view
        gathers.append((img.unfold(0, P, 1).unfold(1, P, 1), y0.long(), x0.long()))
        # the image pixels under the union of the patches read once, every
        # patch pixel written, the origins
        nbytes += covered_pixels(H, W, y0, x0, P, P) * 4 + K * P * P * 4 + K * 8
    args = (imgs, torch.cat(ys), torch.cat(xs), counts, r)
    got = extract_patches_levels(*args)
    want = extract_patches_levels_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "patches differ from the plain version")
    for (windows, yl, xl), part, img in zip(gathers, torch.split(want, counts), imgs):
        check(torch.equal(windows[yl, xl], part), f"unfold gather differs at level shape {tuple(img.shape)}")
    ms = median_ms(lambda: extract_patches_levels(*args))
    plain_ms = median_ms(lambda: extract_patches_levels_plain(*args))
    lib_ms = median_ms(lambda: [windows[yl, xl] for windows, yl, xl in gathers])
    dev_ms = device_ms(lambda: extract_patches_levels(*args), ("extract_patches_levels_kernel",))
    say(f"patches: one launch for the 8 levels ({sum(counts)} patches), equal to the plain version and to the "
        f"unfold gathers at all 8 level shapes; per frame {ms:.4f} ms kernel ({dev_ms:.4f} ms on the device), "
        f"{plain_ms:.4f} ms plain, {lib_ms:.4f} ms for the 8 unfold gathers")
    return {"name": "extract_patches", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/patch_extract.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/patch_extract.py:75",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound(nbytes, 0.0),
            "library_ms": lib_ms}


def stereo_inputs(cfg, dev, rng):
    """A frame of the smoke scene with a constant patch (every window cost
    ties there) and K=512 keypoints: the four corners, x < D + r (strip
    clamped at the left edge), half-pixel coordinates, keypoints in the
    patch, ~10% not valid."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source

    H, W, K = cfg.camera.height, cfg.camera.width, cfg.orb.max_keypoints
    D, r = cfg.stereo.max_disparity, cfg.stereo.block_radius
    left, right = (a.copy() for a in two_plane_frame_source(H, W)(3))
    left[100:140, 600:700] = 128.0
    right[100:140, 500:700] = 128.0
    uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    uv[:10] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0], [3, 200], [D + r - 2, 50], [20.5, 80.5],
               [61.5, 21.5], [650, 120], [660.5, 110]]
    valid = rng.rand(K) > 0.1
    valid[:10] = True
    return [torch.from_numpy(a).to(dev) for a in (left, right, uv, valid)]


def compare_stereo(cfg, dev, rng) -> dict:
    """B2: the raw costs (the TPU kernel's contract, the epilogue off) and
    the fused step (``keypoint_disparity``: origins, costs, argmin,
    sub-pixel step, gates, depth in one launch), each bit-equal to its
    plain version, and ``sparse_disparity``'s two modes equal."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import (
        keypoint_disparity,
        keypoint_disparity_plain,
        keypoint_origins,
        keypoint_stereo_costs,
        keypoint_stereo_costs_plain,
    )
    from stereo_semantic_vo_tpu_torch.ops.stereo import sparse_disparity

    H, W, K = cfg.camera.height, cfg.camera.width, cfg.orb.max_keypoints
    sc = cfg.stereo
    D, r = sc.max_disparity, sc.block_radius
    P, Ws = 2 * r + 1, D + 2 * r
    left, right, uv, kp_valid = stereo_inputs(cfg, dev, rng)
    y0, xl0, xr0, shift = keypoint_origins(uv, H, W, D, r)
    check(int((shift > 0).sum()) >= 2, "no keypoint has its strip clamped at the left edge")
    args = (left, right, y0, xl0, xr0, D, r, sc.color_weight, sc.grad_weight, sc.color_trunc, sc.grad_trunc)
    got = keypoint_stereo_costs(*args)
    want = keypoint_stereo_costs_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"stereo costs differ (max abs {err})")
    cam = Camera.from_config(cfg.camera, dev)
    step = (left, right, uv, kp_valid, cam.bf, D, r, sc.color_weight, sc.grad_weight, sc.color_trunc,
            sc.grad_trunc, sc.uniqueness_ratio, sc.min_disparity)
    got = keypoint_disparity(*step)
    want = keypoint_disparity_plain(*step)
    torch.cuda.synchronize()
    for name, a, b in zip(("disparity", "depth", "valid", "cost"), got, want):
        check(torch.equal(a, b), f"fused stereo step: {name} differs from the plain version")
    a = sparse_disparity(left, right, uv, kp_valid, cam, dataclasses.replace(sc, sparse_mode="pallas"))
    b = sparse_disparity(left, right, uv, kp_valid, cam, dataclasses.replace(sc, sparse_mode="strips"))
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "sparse_disparity's pallas and strips modes differ")
    # the step's device work and host allocations: one kernel, two outputs
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    keypoint_disparity(*step)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    check(allocs <= 2, f"the fused stereo step made {allocs} allocations, expected at most 2")
    ms = median_ms(lambda: keypoint_stereo_costs(*args))
    dev_ms = device_ms(lambda: keypoint_stereo_costs(*args), ("keypoint_stereo_kernel",), only=True)
    plain_ms = median_ms(lambda: keypoint_stereo_costs_plain(*args))
    stage_ms = median_ms(lambda: keypoint_disparity(*step))
    stage_dev_ms = device_ms(lambda: keypoint_disparity(*step), ("keypoint_stereo_kernel",), only=True)
    stage_plain_ms = median_ms(lambda: keypoint_disparity_plain(*step))
    # the union of the left windows and of the right strips, each with a
    # gradient column either side, read once; 10 flops a window term.  The
    # raw call: three origins in, the costs out; the step: uv, kp_valid and
    # bf in, disparity, depth, cost and valid out
    covered = covered_pixels(H, W, y0, xl0 - 1, P, P + 2) + covered_pixels(H, W, y0, xr0 - 1, P, Ws + 2)
    ops = 10.0 * K * D * P * P
    stage_bound = bound(4 * covered + 9 * K + 4 + 13 * K, ops)
    say(f"stereo: raw costs and the fused step (disparity, depth, valid, cost) bit-equal to their plain versions "
        f"({int(got[2].sum())}/{K} valid; corners, left-edge shifts, a tied patch, invalid keypoints), one kernel "
        f"and {allocs} allocations a step; raw {ms:.4f} ms ({dev_ms:.4f} ms on the device), {plain_ms:.4f} ms "
        f"plain; step {stage_ms:.4f} ms ({stage_dev_ms:.4f} ms on the device), {stage_plain_ms:.4f} ms plain, "
        f"bound {stage_bound['bound_ms'] * 1e3:.3f} us")
    return {"name": "keypoint_stereo_costs", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/sparse_stereo.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/sparse_stereo.py:142",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(4 * covered + 4 * K * D + 12 * K, ops),
            "library_ms": None,
            "stage_ms": stage_ms, "stage_device_ms": stage_dev_ms, "stage_plain_ms": stage_plain_ms,
            "stage_bound_ms": stage_bound["bound_ms"], "stage_bound_by": stage_bound["bound_by"],
            "note": "ms / device_ms / plain_ms / bound_ms: the raw call (the TPU kernel's contract); stage_*: "
                    "keypoint_disparity, the whole per-keypoint step in one launch, which the paths run"}


def compare_matcher(cfg, dev, rng, popc_rate: float) -> dict:
    from stereo_semantic_vo_tpu_torch.kernels.matcher import fused_best_match, fused_best_match_plain

    T = cfg.orb.max_keypoints
    ms = dev_ms = plain_ms = bound_ms = 0.0
    for Q in (cfg.window.max_map_points, cfg.orb.max_keypoints):
        q = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
        t = rng.randint(0, 2**32, (T, 8), dtype=np.uint64).astype(np.uint32)
        q[:16] = t[100:116]          # exact matches
        t[7] = t[3]                  # duplicate train rows: ties go to idx 3
        q[20] = t[3]
        args = [torch.from_numpy(a.view(np.int32)).to(dev) for a in (q, t)] + [
            torch.from_numpy(rng.rand(n) > 0.2).to(dev) for n in (Q, T)
        ]
        args[2][30:40] = False  # invalid queries
        got = fused_best_match(*args)
        want = fused_best_match_plain(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("idx", "best", "second"), got, want):
            check(torch.equal(g, w), f"matcher {name} differs at Q={Q}, T={T}")
        ms += median_ms(lambda: fused_best_match(*args))
        dev_ms += device_ms(lambda: fused_best_match(*args), ("fused_best_match_kernel",), only=True)
        plain_ms += median_ms(lambda: fused_best_match_plain(*args))
        b = bound((Q + T) * 33 + 12 * Q, Q * T * 8, popc_rate)  # words and masks in, 3 ints out
        bound_ms += b["bound_ms"]
    # the lanes' strided slices: ties across slices (rows 1, 2) and within
    # one (rows T-33, T-1), every pair masked, sizes off the warp and tile
    for Q, Te in ((2049, 517), (2049, 33), (1, 512), (70, 31), (70, 1)):
        q = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
        t = rng.randint(0, 2**32, (Te, 8), dtype=np.uint64).astype(np.uint32)
        qv, tv = rng.rand(Q) > 0.2, rng.rand(Te) > 0.2
        if Te >= 3:
            t[2] = t[1]
            q[0], qv[0], tv[1:3] = t[1], True, True
        if Te > 32 and Q > 1:
            t[Te - 1] = t[Te - 33]
            q[1], qv[1], tv[Te - 33], tv[Te - 1] = t[Te - 1], True, True, True
        for tmask in (tv, np.zeros(Te, bool)):
            args = [torch.from_numpy(a.view(np.int32)).to(dev) for a in (q, t)] + [
                torch.from_numpy(m).to(dev) for m in (qv, tmask)]
            got, want = fused_best_match(*args), fused_best_match_plain(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("idx", "best", "second"), got, want):
                check(torch.equal(g, w), f"matcher {name} differs at Q={Q}, T={Te} "
                      f"({'all masked' if not tmask.any() else 'ties across and within slices'})")
        check(bool((got[0] == 0).all() and (got[1] == 257).all() and (got[2] == 257).all()),
              f"all-masked rows at Q={Q}, T={Te} must give (0, 257, 257)")
    say(f"matcher: idx, best, second equal at Q=2048 and Q=512 against T={T}, and on ties across and within "
        f"the lanes' slices and all-masked rows at (Q, T) = (2049, 517), (2049, 33), (1, 512), (70, 31), (70, 1); "
        f"per track_step {ms:.4f} ms kernel ({dev_ms:.4f} ms on the device), {plain_ms:.4f} ms plain")
    return {"name": "fused_best_match", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/matcher.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/matcher.py:59",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": b["bound_by"], "library_ms": None}


def frame_aggregations(cfg, dev) -> list[tuple]:
    """The kernel arguments of the SGM calls one dense frame makes, recorded
    from ``dense_disparity`` on a 1241x376 frame: the left and right volumes
    with their P2 planes in one call, then the refine volume at penalty
    scale 0.5."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.ops import dense_stereo

    left, right = (torch.from_numpy(a).to(dev) for a in two_plane_frame_source(cfg.camera.height, cfg.camera.width)(3))
    calls, batch = [], dense_stereo.sgm_aggregate_batch

    def record(vols, cfg, planes, scale=1.0):
        calls.append((list(vols), cfg.p1 * scale, cfg.p2 * scale,
                      [None if h is None else h * scale for h, _ in planes],
                      [None if v is None else v * scale for _, v in planes]))
        return batch(vols, cfg, planes, scale)

    dense_stereo.sgm_aggregate_batch = record
    try:
        dense_stereo.dense_disparity(left, right, cfg.stereo)
    finally:
        dense_stereo.sgm_aggregate_batch = batch
    check([len(c[0]) for c in calls] == [2, 1],
          f"a dense frame made SGM calls of {[len(c[0]) for c in calls]} volumes, expected [2, 1]")
    return calls


def compare_sgm(cfg, dev) -> dict:
    """B6 on a frame's real cost volumes (376x1241x48): scalar P2, and the
    frame's three aggregations through the batched entry (left and right
    with P2 planes in one call; the refine pass at scale 0.5)."""
    from stereo_semantic_vo_tpu_torch.kernels.sgm_scan import sgm_aggregate_batch, sgm_aggregate_plain

    calls = frame_aggregations(cfg, dev)
    (vol_l, vol_r), p1, p2, hs, vs = calls[0]
    (vol_f,), p1f, p2f, (hf,), (vf,) = calls[1]
    got = [sgm_aggregate_batch([vol_l], p1, p2)[0], *sgm_aggregate_batch(*calls[0]),
           sgm_aggregate_batch(*calls[1])[0]]
    want = [sgm_aggregate_plain(vol_l, p1, p2), sgm_aggregate_plain(vol_l, p1, p2, hs[0], vs[0]),
            sgm_aggregate_plain(vol_r, p1, p2, hs[1], vs[1]), sgm_aggregate_plain(vol_f, p1f, p2f, hf, vf)]
    torch.cuda.synchronize()
    names = ("scalar P2", "left, P2 planes", "right, P2 planes", "refine, scale 0.5")
    for name, g, w in zip(names, got, want):
        check(torch.equal(g, w), f"SGM kernel differs from its plain version ({name}): "
              f"max abs {float((g - w).abs().max())}")
    # a frame's SGM work, kernel and plain: the left + right call, then the refine call
    ms = median_ms(lambda: [sgm_aggregate_batch(*c) for c in calls], reps=20, warmup=2)
    dev_ms = device_ms(lambda: [sgm_aggregate_batch(*c) for c in calls], ("sgm_sweeps_kernel", "sgm_sum_kernel"))
    plain_ms = median_ms(lambda: [sgm_aggregate_plain(*a) for a in
                                  ((vol_l, p1, p2, hs[0], vs[0]), (vol_r, p1, p2, hs[1], vs[1]),
                                   (vol_f, p1f, p2f, hf, vf))], reps=5, warmup=1)
    say("sgm: bit-equal to the plain version at 376x1241x48 (scalar P2, the frame's left and right "
        "aggregations with P2 planes in one call, its refine at scale 0.5); per frame (3 aggregations, 2 calls, "
        f"4 launches) {ms:.3f} ms kernel ({dev_ms:.3f} ms on the device), {plain_ms:.1f} ms plain")
    # per aggregation: the volume in, the sum out, the P2 planes; ~8 flops
    # per cell and direction (the d +- 1 and P2 candidates, their min, the
    # minus prev_min, the add into the sum), 4 directions
    aggs = [(v, h, w) for c in calls for v, h, w in zip(c[0], c[3], c[4])]
    nbytes = sum(2 * v.numel() * 4 + sum(p.numel() * 4 for p in (h, w) if p is not None) for v, h, w in aggs)
    ops = sum(32.0 * v.numel() for v, _, _ in aggs)
    return {"name": "sgm_aggregate", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/sgm_scan.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/sgm_scan.py:117",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": None}


def compare_cost_volumes(cfg, dev) -> dict:
    """The dense path's two cost volumes (376x1241x48, r=3) in one launch,
    bit-equal to ``cost_volume`` of each base on the card: a frame of the
    scene and random images; the frame's time beside the plain loop's."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.kernels.cost_volume import cost_volumes, cost_volumes_plain

    H, W, sc = cfg.camera.height, cfg.camera.width, cfg.stereo
    D, P = sc.max_disparity, 2 * sc.block_radius + 1
    rng = np.random.RandomState(7)
    pairs = [tuple(torch.from_numpy(a).to(dev) for a in two_plane_frame_source(H, W)(3)),
             tuple(torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev) for _ in range(2))]
    for name, (left, right) in zip(("scene frame", "random"), pairs):
        got, want = cost_volumes(left, right, sc), cost_volumes_plain(left, right, sc)
        torch.cuda.synchronize()
        for base, g, w in zip(("left", "right"), got, want):
            check(torch.equal(g, w), f"cost volumes ({name}, {base}-based) differ from the plain loop: "
                  f"max abs {float((g - w).abs().max())}")
    left, right = pairs[0]
    ms = median_ms(lambda: cost_volumes(left, right, sc))
    dev_ms = device_ms(lambda: cost_volumes(left, right, sc), ("dense_cost_volumes_kernel",), only=True)
    plain_ms = median_ms(lambda: cost_volumes_plain(left, right, sc), reps=5, warmup=1)
    plain_dev_ms = device_ms(lambda: cost_volumes_plain(left, right, sc), (), reps=3)
    # the two images read once and both volumes written once; a raw cost
    # 9 flops, its window sum 49 adds and the multiply
    nbytes, ops = 4.0 * (2 * H * W + 2 * H * W * D), 2.0 * H * W * D * (9 + P * P + 1)
    b = bound(nbytes, ops)
    say(f"cost volumes: both {H}x{W}x{D} volumes of one launch bit-equal to the plain loop (a scene frame, random "
        f"images); per frame {ms:.4f} ms kernel ({dev_ms:.4f} ms on the device), {plain_ms:.3f} ms plain "
        f"({plain_dev_ms:.3f} ms on the device), bound {b['bound_ms'] * 1e3:.1f} us ({b['bound_by']})")
    return {"name": "cost_volumes", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/cost_volume.cu",
            "replaces": "none (stereo_semantic_vo_tpu/ops/dense_stereo.py:cost_volume, XLA)",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_device_ms": plain_dev_ms, **b, "library_ms": None}


def local_ba_problem(cam_cfg, dev, F=4, L=2048, seed=0):
    """F poses along the path, L landmarks 8-50 m ahead, noisy observations
    with ~80% observed and ~70% of those with a stereo u_R."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)], -1).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    poses[:, 0, 3] = -0.8 * np.arange(F)
    poses[:, 2, 3] = 0.3 * np.arange(F)
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    u = cam_cfg.fx * pc[..., 0] / pc[..., 2] + cam_cfg.cx
    v = cam_cfg.fy * pc[..., 1] / pc[..., 2] + cam_cfg.cy
    obs = (np.stack([u, v], -1) + rng.normal(0, 1.5, (F, L, 2))).astype(np.float32)
    mask = (pc[..., 2] > 0.5) & (rng.rand(F, L) < 0.8)
    ur = (u - cam_cfg.bf / pc[..., 2] + rng.normal(0, 1.2, u.shape)).astype(np.float32)
    rm = mask & (rng.rand(F, L) > 0.3)
    return [torch.from_numpy(a).to(dev) for a in (poses, X, obs, mask, ur, rm)]


def compare_local_ba(cfg, dev) -> dict:
    """B7 at the window's shape: F=4 poses, L=2048 landmarks, stereo row;
    the bound build a ``local_ba`` step makes against one-shot calls and the
    plain build; one ``local_ba`` (5 LM steps) timed with either build."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.kernels.ba_hessian import (
        LocalBABuild,
        local_ba_blocks,
        local_ba_blocks_plain,
    )
    from stereo_semantic_vo_tpu_torch.ops.local_ba import local_ba

    cam = Camera.from_config(cfg.camera, dev)
    poses, X, obs, mask, ur, rm = local_ba_problem(cfg.camera, dev, cfg.window.window_frames, cfg.window.max_map_points)
    args = (poses, X, obs, mask, cam, cfg.ba.huber_delta, ur, rm)
    step_build = LocalBABuild(obs, mask, cam, cfg.ba.huber_delta, ur, rm)
    got = local_ba_blocks(*args)
    again = local_ba_blocks(*args)
    steps = [step_build(poses, X), step_build(poses, X)]
    want = local_ba_blocks_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("Hcc", "Hcp", "Hpp", "gc", "gp"), got, want):
        atol = BA_ATOL_REL * max(float(b.abs().max()), 1.0)
        check(torch.allclose(a, b, rtol=BA_RTOL, atol=atol),
              f"local-BA {name} differs from the plain build (max abs {float((a - b).abs().max())})")
        err = max(err, float((a - b).abs().max()))
    check(torch.allclose(got[5], want[5], rtol=BA_COST_RTOL, atol=0.0),
          f"local-BA cost {float(got[5])} vs plain {float(want[5])}")
    check(all(torch.equal(a, b) for x in (again, *steps) for a, b in zip(got, x)),
          "local-BA kernel is not deterministic (one-shot calls and a bound build's steps)")
    ms = median_ms(lambda: local_ba_blocks(*args))
    step_ms = median_ms(lambda: step_build(poses, X))
    dev_ms = device_ms(lambda: step_build(poses, X), ("local_ba_blocks_kernel",), only=True)
    plain_ms = median_ms(lambda: local_ba_blocks_plain(*args))
    F, L = mask.shape
    X0 = X + 0.1
    valid = torch.ones(L, dtype=torch.bool, device=dev)
    lm = {}
    for backend in ("pallas", "xla"):
        bcfg = dataclasses.replace(cfg.ba, local_hessian_backend=backend)
        lm[backend] = median_ms(lambda: local_ba(poses, X0, obs, mask, valid, cam, bcfg, obs_ur=ur, obs_r_mask=rm),
                                reps=20, warmup=2)
    say(f"local-BA blocks: F=4, L=2048 with the stereo row within rtol {BA_RTOL} / atol {BA_ATOL_REL} x max "
        f"(max abs err {err:.4g}), cost within rtol {BA_COST_RTOL}, one-shot calls and a bound build's steps "
        f"bit-equal; per build {ms:.4f} ms one-shot ({step_ms:.4f} ms a step of the bound build, {dev_ms:.4f} ms "
        f"on the device, one kernel), {plain_ms:.4f} ms plain; one local_ba ({cfg.ba.local_iterations} LM steps) "
        f"{lm['pallas']:.3f} ms with the kernel, {lm['xla']:.3f} ms with the plain build")
    # poses, points, observations, u_R, intrinsics (float32) and the two
    # masks (bool) in; Hcc, Hcp, Hpp, gc, gp, cost out; ~600 flops per
    # (frame, landmark)
    nbytes = 4 * (16 * F + 3 * L + 3 * F * L + 5) + 2 * F * L + 4 * (36 * F + 18 * F * L + 9 * L + 6 * F + 3 * L + 1)
    return {"name": "local_ba_blocks", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/ba_hessian.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/ba_hessian.py:270",
            "max_abs_err": err, "ms": ms, "step_ms": step_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(nbytes, 600.0 * F * L),
            "library_ms": None,
            "local_ba_ms": lm}


def compare_fast(cfg, dev, rng) -> dict:
    """B4: one call for a frame's 8 levels (scores at both thresholds, the
    border mask and the 3x3 NMS fused) bit-equal to its plain version at
    every level, on a real frame's pyramid and on integer-valued textures
    at the same shapes (integer scores: ties under the NMS); the raw
    one-level scores (the TPU kernel's contract) bit-equal to theirs; then
    extract_orb with the kernel against the rolled ring."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.kernels.fast_score import (
        fast_scores,
        fast_scores_levels,
        fast_scores_levels_plain,
        fast_scores_plain,
    )
    from stereo_semantic_vo_tpu_torch.ops.orb import extract_orb, pyramid

    oc = cfg.orb
    ths, b = (float(oc.fast_threshold), float(oc.fast_min_threshold)), oc.border
    levels = pyramid(torch.from_numpy(two_plane_frame_source(cfg.camera.height, cfg.camera.width)(3)[0]).to(dev), oc)
    shapes = [(H, W) for H, W, _ in pyramid_shapes(oc, cfg.camera.height, cfg.camera.width)]
    check([tuple(x.shape) for x in levels] == shapes, f"pyramid shapes {[tuple(x.shape) for x in levels]}")
    textures = [torch.from_numpy(np.round(rng.uniform(0, 255, s)).astype(np.float32)).to(dev) for s in shapes]
    for name, lv in (("frame", levels), ("integer texture", textures)):
        got, want = fast_scores_levels(lv, ths, b), fast_scores_levels_plain(lv, ths, b)
        torch.cuda.synchronize()
        for img, maps, plain in zip(lv, got, want):
            for j, (g, w) in enumerate(zip(maps, plain)):
                check(torch.equal(g, w), f"fused FAST maps differ ({name}, level shape {tuple(img.shape)}, "
                      f"threshold {ths[j]}): max abs {float((g - w).abs().max())}")
    for img in levels:
        for g, w in zip(fast_scores(img, ths), fast_scores_plain(img, ths)):
            check(torch.equal(g, w), f"raw FAST scores differ at level shape {tuple(img.shape)}: "
                  f"max abs {float((g - w).abs().max())}")
    torch.cuda.synchronize()
    ms = median_ms(lambda: fast_scores_levels(levels, ths, b))
    dev_ms = device_ms(lambda: fast_scores_levels(levels, ths, b), ("fast_scores_levels_kernel",), only=True)
    plain_ms = median_ms(lambda: fast_scores_levels_plain(levels, ths, b), reps=20, warmup=2)
    # each level read once, a map per threshold written; 16 differences,
    # per threshold 32 subtractions, two 16-term sums and a max, then the
    # NMS's 9 maxima and a compare
    px = sum(img.numel() for img in levels)
    nbytes, ops = px * 4 * (1 + len(ths)), px * (16 + 73 * len(ths))
    a = extract_orb(levels[0], dataclasses.replace(oc, fast_backend="pallas"))
    b_ = extract_orb(levels[0], dataclasses.replace(oc, fast_backend="xla"))
    for name, x, y in zip(a._fields, a, b_):
        check(torch.equal(x, y), f"extract_orb with the FAST kernel differs from the rolled ring in {name}")
    say(f"fast scores: one launch for the 8 levels (376x1241 ... 106x346) with the border mask ({b} px) and the "
        f"3x3 NMS, bit-equal to the plain version at thresholds {ths} on a frame and on integer textures; raw "
        f"one-level scores bit-equal; extract_orb keypoints equal to the rolled ring's ({int(a.valid.sum())} "
        f"valid); per frame {ms:.4f} ms kernel ({dev_ms:.4f} ms on the device), {plain_ms:.4f} ms plain")
    return {"name": "fast_scores", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/fast_score.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/fast_score.py:93",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": None}


def motion_problem(cam_cfg, dev, K=512, seed=0, noise=0.4):
    """tests/test_ba_hessian.py's problem: K points 5-60 m ahead seen from a
    known pose with pixel noise, ~10% masked; -> (T0, X, uv, mask) with T0
    a small perturbation of the true pose."""
    from stereo_semantic_vo_tpu_torch.core import lie

    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-20, 20, K), rng.uniform(-5, 5, K), rng.uniform(5, 60, K)], -1).astype(np.float32)
    T_true = lie.se3_exp(torch.tensor([0.3, -0.1, 0.5, 0.02, -0.03, 0.01])).numpy()
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([cam_cfg.fx * pc[:, 0] / pc[:, 2] + cam_cfg.cx, cam_cfg.fy * pc[:, 1] / pc[:, 2] + cam_cfg.cy], -1)
    uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    mask = (pc[:, 2] > 0.5) & (rng.rand(K) > 0.1)
    T0 = lie.se3_exp(torch.tensor([0.05, 0.0, -0.04, 0.004, 0.0, -0.003])).numpy() @ T_true
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (T0.astype(np.float32), X, uv, mask)]


def compare_motion_hessian(cfg, dev) -> dict:
    """B5 at K=512: within tests/test_ba_hessian.py's bounds, deterministic,
    the bound build a ``motion_only_ba`` step makes equal to one-shot calls;
    one step and one motion_only_ba (10 calls) timed."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.kernels.ba_hessian import (
        MotionBuild,
        motion_hessian_gradient,
        motion_hessian_gradient_plain,
        motion_intrinsics,
    )
    from stereo_semantic_vo_tpu_torch.ops.ba import motion_only_ba

    cam = Camera.from_config(cfg.camera, dev)
    T0, X, uv, mask = motion_problem(cfg.camera, dev)
    K = X.shape[0]
    operands = (X.T.contiguous(), uv.T.contiguous(), mask.to(torch.float32)[None], motion_intrinsics(cam),
                cfg.ba.huber_delta)
    args = (T0, *operands)
    step_build = MotionBuild(*operands)
    got = motion_hessian_gradient(*args)
    again = motion_hessian_gradient(*args)
    step = [x.clone() for x in step_build(T0)]
    want = motion_hessian_gradient_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("H", "g"), got, want):
        atol = MH_ATOL_REL * float(b.abs().max())
        check(torch.allclose(a, b, rtol=MH_RTOL, atol=atol),
              f"motion build {name} differs from the plain build (max abs {float((a - b).abs().max())})")
        err = max(err, float((a - b).abs().max()))
    check(torch.allclose(got[2], want[2], rtol=MH_COST_RTOL, atol=0.0),
          f"motion build cost {float(got[2])} vs plain {float(want[2])}")
    check(all(torch.equal(a, b) for x in (again, step) for a, b in zip(got, x)),
          "motion build kernel is not deterministic (one-shot calls and a bound build's step)")
    ms = median_ms(lambda: motion_hessian_gradient(*args))
    step_ms = median_ms(lambda: step_build(T0))
    dev_ms = device_ms(lambda: step_build(T0), ("motion_hessian_kernel",), only=True)
    plain_ms = median_ms(lambda: motion_hessian_gradient_plain(*args))
    lm = {}
    for backend in ("pallas", "xla"):
        bcfg = dataclasses.replace(cfg.ba, hessian_backend=backend, trim_px=10.0)
        lm[backend] = median_ms(lambda: motion_only_ba(T0, X, uv, mask, cam, bcfg), reps=20, warmup=2)
    say(f"motion build: K={K} within rtol {MH_RTOL} / atol {MH_ATOL_REL} x max (max abs err {err:.4g}), "
        f"cost within rtol {MH_COST_RTOL}, one-shot calls and a bound build's step bit-equal; per call {ms:.4f} ms "
        f"one-shot ({step_ms:.4f} ms a step of the bound build, {dev_ms:.4f} ms on the device, one kernel), "
        f"{plain_ms:.4f} ms plain; one motion_only_ba (10 LM steps, trim 10 px) {lm['pallas']:.3f} ms with the kernel, "
        f"{lm['xla']:.3f} ms with the einsum build")
    # pose, points, observations, mask, intrinsics in; H, g, cost out;
    # ~230 flops an observation
    nbytes = 4 * (16 + 6 * K + 4) + 4 * 43
    return {"name": "motion_hessian_gradient", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/ba_hessian.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/ba_hessian.py:115",
            "max_abs_err": err, "ms": ms, "step_ms": step_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(nbytes, 230.0 * K),
            "library_ms": None,
            "motion_only_ba_ms": lm}


def compare_hamming_matrix(cfg, dev, rng, popc_rate: float) -> dict:
    """B8 at Q=2048 and Q=512 against T=512, against its plain version and
    against ``torch.cdist(p=0)`` on the descriptors unpacked to 0/1 bits."""
    from stereo_semantic_vo_tpu_torch.kernels.hamming import (
        DESC_BITS,
        hamming_distance_matrix,
        hamming_distance_matrix_pallas,
    )

    T = cfg.orb.max_keypoints
    shifts = torch.arange(32, device=dev)

    def bits(d):
        return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], DESC_BITS).to(torch.float32)

    ms = dev_ms = plain_ms = lib_ms = bound_ms = 0.0
    for Q in (cfg.window.max_map_points, cfg.orb.max_keypoints):
        q = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
        t = rng.randint(0, 2**32, (T, 8), dtype=np.uint64).astype(np.uint32)
        q[:16] = t[100:116]  # distance 0
        qd, td = (torch.from_numpy(a.view(np.int32)).to(dev) for a in (q, t))
        got = hamming_distance_matrix_pallas(qd, td)
        want = hamming_distance_matrix(qd, td)
        qb, tb = bits(qd), bits(td)
        lib = torch.cdist(qb, tb, p=0)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"Hamming matrix differs from its plain version at Q={Q}, T={T}")
        check(torch.equal(lib.to(torch.int32), want), f"torch.cdist(p=0) differs from the Hamming matrix at Q={Q}")
        ms += median_ms(lambda: hamming_distance_matrix_pallas(qd, td))
        dev_ms += device_ms(lambda: hamming_distance_matrix_pallas(qd, td), ("hamming_matrix_kernel",), only=True)
        plain_ms += median_ms(lambda: hamming_distance_matrix(qd, td))
        lib_ms += median_ms(lambda: torch.cdist(qb, tb, p=0))
        b = bound((Q + T) * 32 + Q * T * 4, Q * T * 8, popc_rate)  # words in, the matrix out
        bound_ms += b["bound_ms"]
    for Q, Te in ((2049, 513), (1, 511), (70, 1)):  # ragged: T no multiple of a thread's 4 columns
        qd, td = (torch.from_numpy(rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
                  .to(dev) for n in (Q, Te))
        check(torch.equal(hamming_distance_matrix_pallas(qd, td), hamming_distance_matrix(qd, td)),
              f"Hamming matrix differs from its plain version at Q={Q}, T={Te}")
    say(f"hamming matrix: equal to the plain version and to torch.cdist(p=0) at Q=2048 and Q=512 against "
        f"T={T}, and to the plain version at (Q, T) = (2049, 513), (1, 511), (70, 1); both calls {ms:.4f} ms "
        f"kernel ({dev_ms * 1e3:.2f} us on the device, bound {bound_ms * 1e3:.2f} us), {plain_ms:.4f} ms plain, "
        f"{lib_ms:.4f} ms cdist")
    return {"name": "hamming_distance_matrix_pallas", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/hamming.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/hamming.py:73",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": b["bound_by"], "library_ms": lib_ms,
            "note": "no path of either package calls it; its shapes are the matcher's"}


def frames(cfg, n: int):
    """(idx, left, right, boxes, boxes_valid, timestamp) of the procedural
    sequence; every fifth frame carries one detection box (culling path)."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source

    src = two_plane_frame_source(cfg.camera.height, cfg.camera.width)
    nb = cfg.semantic.max_boxes
    for t in range(n):
        left, right = src(t)
        boxes = np.zeros((nb, 4), np.float32)
        valid = np.zeros(nb, bool)
        if t % 5 == 2:
            boxes[0] = [500.0, 60.0, 700.0, 300.0]
            valid[0] = True
        yield t, left, right, boxes, valid, t / cfg.camera.fps


def rotation_angle(R: np.ndarray) -> float:
    """Angle in radians of the rotation matrix R, in float64:
    atan2(|vee(R - R^T)| / 2, (tr R - 1) / 2), which resolves a small
    rotation where the arccos of the trace reads one float32 ulp of it as
    4.9e-4 rad (tests/torch_parity.rot_angle is the same)."""
    R = np.asarray(R, np.float64)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(vee) / 2.0, (np.trace(R) - 1.0) / 2.0))


def run_slice(cfg, dev, n: int, local_ba_every: int = 0, detector=None, frame_source=None, ba_mesh=None,
              capture=None):
    """``VOPipeline(cfg, device=dev, ...)`` over ``n`` frames of the scene
    (on a card it replays CUDA graphs unless ``capture=False``)."""
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline

    pipe = VOPipeline(cfg, device=dev, local_ba_every=local_ba_every, detector=detector, ba_mesh=ba_mesh,
                      capture=capture)
    t0 = time.perf_counter()
    pipe.run(frames(cfg, n) if frame_source is None else frame_source)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return pipe, time.perf_counter() - t0


def drive_path(label: str, cfg, dev, n_frames: int, local_ba_every: int, kernels: dict, expected: dict,
               detector=None, ba_mesh=None):
    """Run one path on the card with every launch count set to 0 just
    before; check the counts, tracking and ground truth.  -> (pipe, wall
    seconds, poses, launches)."""
    for k in kernels.values():
        k.launches = 0
    pipe, wall = run_slice(cfg, dev, n_frames, local_ba_every, detector, ba_mesh=ba_mesh)
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches == expected, f"{label}: kernel launches {launches}, expected {expected}")
    poses = np.stack([o.T_wc.cpu().numpy() for o in pipe.outputs])
    check(len(poses) == n_frames and bool(np.isfinite(poses).all()), f"{label}: non-finite or missing poses")
    ok = [bool(o.pnp_ok) for o in pipe.outputs]
    check(all(ok[1:]), f"{label}: tracking lost at frames {[i for i, v in enumerate(ok) if not v]}")
    gt = ground_truth(cfg, n_frames)
    pos_err, rot_err = pose_errors(poses, gt)
    check(pos_err <= POS_BOUND_M, f"{label}: position error {pos_err:.4f} m > {POS_BOUND_M} m")
    check(rot_err <= ROT_BOUND_RAD, f"{label}: rotation error {rot_err:.5f} rad > {ROT_BOUND_RAD} rad")
    n = lambda f: [int(getattr(o, f)) for o in pipe.outputs]  # noqa: E731
    say(f"{label}: {n_frames} frames 1241x376 on the card, all tracked; max position error "
        f"{pos_err:.5f} m over {gt[-1, 0, 3]:.3f} m (bound {POS_BOUND_M}), max rotation error "
        f"{rot_err:.6f} rad; launches {launches}")
    say(f"{label} counters: stereo {n('n_stereo')}; matches_last {n('n_matches_last')}; matches_map "
        f"{n('n_matches_map')}; pnp_inliers {n('n_pnp_inliers')}; culled {n('n_culled_dynamic')}")
    return pipe, wall, poses, launches


def no_sync(label: str, fn) -> None:
    """``fn()`` reads nothing back to the host (PyTorch's sync debug mode
    raises on a synchronizing call; it is a prototype and may miss some)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    say(f"no-sync: {label} under torch.cuda.set_sync_debug_mode('error') raised nothing")


def cpu_rerun(label: str, cfg, n_frames: int, gpu_poses: np.ndarray, local_ba_every: int = 0) -> None:
    """The first frames again on the host CPU (plain versions); poses agree."""
    cpu_pipe, cpu_wall = run_slice(cfg, torch.device("cpu"), n_frames, local_ba_every)
    cpu_poses = np.stack([o.T_wc.numpy() for o in cpu_pipe.outputs])
    dpos = np.abs(cpu_poses[:, :3, 3] - gpu_poses[:n_frames, :3, 3]).max()
    drot = max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(cpu_poses, gpu_poses))
    check(dpos <= CPU_POS_TOL_M and drot <= CPU_ROT_TOL_RAD,
          f"{label}: CPU vs GPU poses differ by {dpos} m / {drot} rad")
    say(f"{label} cpu rerun: {n_frames} frames, max pose difference {dpos:.2e} m, {drot:.2e} rad "
        f"({cpu_wall / n_frames * 1000:.1f} ms/frame on the host CPU)")


def steady_state(label: str, pipe, n_frames: int, wall: float, card: str) -> tuple[float, float]:
    """-> the median and p90 ms/frame over frames 5 on, printed with the card."""
    steady = np.array(pipe.frame_times[5:]) * 1000.0
    med, p90 = float(np.median(steady)), float(np.percentile(steady, 90))
    say(f"{label} steady state: median {med:.3f} ms/frame, p90 {p90:.3f} ms (frames 5-{n_frames - 1}, host "
        f"clock, one-frame-deferred readback); whole run {wall:.2f} s incl. first-frame warm-up; card {card}")
    return med, p90


class Recorder:
    """A detector that keeps every ``Detections`` it hands out (device
    tensors, in call order): the pipeline calls it once a frame."""

    def __init__(self, det):
        self.det, self.device, self.seen = det, det.device, []

    def detect(self, img):
        out = self.det.detect(img)
        self.seen.append(out)
        return out


def frame_boxes(det, nb: int) -> tuple[np.ndarray, np.ndarray]:
    """A frame's detections as the pipeline hands them to the step: cut or
    zero-padded to ``nb`` boxes, on the host."""
    boxes, valid = np.zeros((nb, 4), np.float32), np.zeros(nb, bool)
    k = min(nb, det.boxes.shape[0])
    boxes[:k], valid[:k] = det.boxes[:k].cpu().numpy(), det.valid[:k].cpu().numpy()
    return boxes, valid


def detector_work(det, img: torch.Tensor) -> tuple[float, float]:
    """-> (FLOPs, bytes) of one ``detect``: the convolutions' FLOPs as
    ``FlopCounterMode`` counts them on this run's shapes (2 a multiply-add);
    the frame and the weights read once, the detections written once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        det.detect(img)
    weights = sum(b.numel() * b.element_size() for b in det.net.buffers())
    return float(fc.get_total_flops()), float(img.numel() * 4 + weights + det.max_boxes * 4 * 7)


def device_events(fn) -> tuple[int, int]:
    """(kernels, copies and fills) on the device in one ``fn()``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then the profiler hands back an empty window: take another
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    check(bool(names), "the profiler saw no device event")
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return len(names) - copies, copies


def compare_detector(cfg, dev, card: str):
    """The online detector on frame 0 of the scene, on the card and on the
    CPU: head maps, valid masks and boxes; detect timed beside its bound,
    and once under sync debug mode.  -> the card's detector."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.models import zoo

    gpu, cpu = zoo.kitti_tiny_v2(device=dev), zoo.kitti_tiny_v2(device="cpu")
    img = torch.from_numpy(two_plane_frame_source(cfg.camera.height, cfg.camera.width)(0)[0] / 255.0)
    img_dev = img.to(dev)
    err = 0.0
    for (sec, a), (_, b) in zip(gpu.heads(img_dev), cpu.heads(img)):
        a = a.cpu()
        err = max(err, float((a - b).abs().max()))
        check(torch.allclose(a, b, rtol=DET_RTOL, atol=DET_ATOL_REL * float(b.abs().max())),
              f"detector {sec['type']} head differs on the card: max abs {float((a - b).abs().max())}")
    got, want = gpu.detect(img_dev), cpu.detect(img)
    v = want.valid
    check(torch.equal(got.valid.cpu(), v), "detector valid masks differ between the card and the CPU")
    check(bool(v.any()), "the detector found nothing on frame 0 at its default threshold")
    box_err = float((got.boxes.cpu()[v] - want.boxes[v]).abs().max())
    check(box_err <= DET_BOX_TOL_PX, f"detected boxes differ by {box_err} px between the card and the CPU")
    ms = median_ms(lambda: gpu.detect(img_dev), reps=20)
    dev_ms = device_ms(lambda: gpu.detect(img_dev), ())
    n_kernels, n_copies = device_events(lambda: gpu.detect(img_dev))
    t0 = time.perf_counter()
    cpu.detect(img)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    flops, nbytes = detector_work(gpu, img_dev)
    b = bound(nbytes, flops)
    no_sync("one detect", lambda: gpu.detect(img_dev))
    say(f"detector: kitti_tiny_v2 (352x352, random weights from seed 0) on a 1241x376 frame, card vs CPU: heads "
        f"within rtol {DET_RTOL} / atol {DET_ATOL_REL} x max (max abs {err:.3g}), {int(v.sum())}/{len(v)} valid on "
        f"both, boxes within {box_err:.3g} px; per detect {ms:.4f} ms ({dev_ms:.4f} ms on the device, {n_kernels} "
        f"kernels and {n_copies} copies or fills), {cpu_ms:.1f} ms on the host CPU; bound {b['bound_ms'] * 1e3:.2f} "
        f"us by {b['bound_by']} ({flops / 1e9:.3f} GFLOP at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s float32, "
        f"{nbytes / 1e6:.2f} MB at {HBM_BYTES_PER_S / 1e12} TB/s); card {card}")
    return gpu


def replay_frames(cfg, n: int, seen: list):
    """``frames(cfg, n)`` with frame t's offline boxes replaced by the online
    run's detections of frame t-1 (none on frame 0)."""
    nb = cfg.semantic.max_boxes
    for t, left, right, _, _, ts in frames(cfg, n):
        boxes, valid = frame_boxes(seen[t - 1], nb) if t > 0 else (np.zeros((nb, 4), np.float32), np.zeros(nb, bool))
        yield t, left, right, boxes, valid, ts


def side_stream_overlap(pipe, cfg, t: int) -> dict:
    """Profile frame t's ``process_frame``: the side stream's kernels (those
    not on the stream of the step's patch kernel) against the main stream's,
    from the trace's kernel intervals."""
    left, right = next(f for f in frames(cfg, t + 1) if f[0] == t)[1:3]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipe.process_frame(left, right, None, None, t / cfg.camera.fps)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    main = {e["args"]["stream"] for e in events if "extract_patches" in e["name"]}
    check(len(main) == 1, f"the step's patch kernel ran on streams {sorted(main)}")
    ivs = {"main": [], "side": []}
    for e in events:
        ivs["main" if e["args"]["stream"] in main else "side"].append((e["ts"], e["ts"] + e["dur"]))
    check(bool(ivs["side"]), "no kernel ran on a side stream in an online frame")

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    m, sd = union(ivs["main"]), union(ivs["side"])
    overlap = sum(max(0.0, min(b, d) - max(a, c)) for a, b in m for c, d in sd)
    span = lambda iv: (min(a for a, _ in iv), max(b for _, b in iv))  # noqa: E731
    (m0, m1), (s0, s1) = span(ivs["main"]), span(ivs["side"])
    return {"main_kernels": len(ivs["main"]), "side_kernels": len(ivs["side"]),
            "main_busy_ms": sum(b - a for a, b in m) / 1e3, "side_busy_ms": sum(b - a for a, b in sd) / 1e3,
            "overlap_ms": overlap / 1e3, "side_span_ms": ((s0 - m0) / 1e3, (s1 - m0) / 1e3),
            "main_span_ms": (0.0, (m1 - m0) / 1e3)}


def drive_online(cfg, dev, det, kernels: dict, expected: dict, slice_steady, card: str) -> dict:
    """The fourth path: ``VOPipeline(detector=det, async_detect=True)`` on
    the card.  -> its launch counts."""
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, track_step
    from stereo_semantic_vo_tpu_torch.models import zoo

    n_o = N_ONLINE_FRAMES
    pipe, wall, poses, launches = drive_path("online", cfg, dev, n_o, 0, kernels, expected, detector=det)
    # the detections of each frame, from the same path dispatched eagerly
    # (under graphs the detector's Python runs only at capture): bit for bit
    # the graph run
    rec = Recorder(det)
    eager, _ = run_slice(cfg, dev, n_o, detector=rec, capture=False)
    check(len(rec.seen) == n_o, f"online: {len(rec.seen)} detections for {n_o} frames")
    check(np.array_equal(np.stack([o.T_wc.cpu().numpy() for o in eager.outputs]), poses),
          "online: the eager run's poses differ from the graph run's")
    n_valid = [int(d.valid.sum()) for d in rec.seen]
    culled = [int(o.n_culled_dynamic) for o in pipe.outputs]
    say(f"online: valid boxes detected per frame {n_valid}; frame t tracks with frame t-1's; culled points per "
        f"frame {culled}")
    check(any(n_valid[:-1]), "online: no frame was tracked with a valid box")
    # the same frames through the sparse path, each with the online run's
    # detections of the frame before as offline boxes
    replay, _ = run_slice(cfg, dev, n_o, frame_source=replay_frames(cfg, n_o, rec.seen))
    replay_poses = np.stack([o.T_wc.cpu().numpy() for o in replay.outputs])
    dpos = float(np.abs(replay_poses[:, :3, 3] - poses[:, :3, 3]).max())
    drot = max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(replay_poses, poses))
    check(dpos <= REPLAY_POS_TOL_M and drot <= REPLAY_ROT_TOL_RAD,
          f"online vs its detections replayed one frame late: poses differ by {dpos} m / {drot} rad")
    say(f"online vs the sparse path fed its detections one frame late: {n_o} frames, max pose difference "
        f"{dpos:.3g} m, {drot:.3g} rad; bit for bit: {bool(np.array_equal(replay_poses, poses))}")
    # no sync: a step with the pending detections, and a frame's dispatch
    # with the deferred readback of the frame before set aside
    last = list(frames(cfg, n_o + 1))[-1]
    boxes, valid = pipe._det_pending
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:3]), boxes, valid)
    no_sync("one online track_step with pending detections", lambda: track_step(pipe.state, frame, cfg))
    held = []
    finalize, pipe._finalize = pipe._finalize, lambda *item: held.append(item)
    no_sync("one online process_frame (stale boxes awaited, detection queued on the side stream)",
            lambda: pipe.process_frame(last[1], last[2], None, None, last[5]))
    pipe._finalize = finalize
    for item in held:
        finalize(*item)
    # the first frames on the host CPU, the detector there too
    cpu_rec = Recorder(zoo.kitti_tiny_v2(device="cpu"))
    n_c = N_ONLINE_CPU_FRAMES
    cpu_pipe, cpu_wall = run_slice(cfg, torch.device("cpu"), n_c, detector=cpu_rec)
    cpu_poses = np.stack([o.T_wc.numpy() for o in cpu_pipe.outputs])
    dpos = np.abs(cpu_poses[:, :3, 3] - poses[:n_c, :3, 3]).max()
    drot = max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(cpu_poses, poses))
    cpu_valid = [int(d.valid.sum()) for d in cpu_rec.seen]
    check(dpos <= CPU_POS_TOL_M and drot <= CPU_ROT_TOL_RAD, f"online: CPU vs GPU poses differ by {dpos} m / {drot} rad")
    check(cpu_valid == n_valid[:n_c], f"online: valid boxes per frame {cpu_valid} on the CPU, {n_valid[:n_c]} on the card")
    say(f"online cpu rerun: {n_c} frames with the detector on the CPU, max pose difference {dpos:.2e} m, {drot:.2e} "
        f"rad, valid boxes per frame equal ({cpu_wall / n_c * 1000:.1f} ms/frame on the host CPU)")
    steady = steady_state("online", pipe, n_o, wall, card)
    say("online beside the sparse path in this call: median / p90 {:.3f} / {:.3f} against {:.3f} / {:.3f} "
        "ms/frame".format(*steady, *slice_steady))
    ov = side_stream_overlap(pipe, cfg, n_o + 1)
    say(f"online profiled frame: main stream {ov['main_kernels']} kernels, {ov['main_busy_ms']:.3f} ms busy over "
        f"[0, {ov['main_span_ms'][1]:.3f}] ms; side stream {ov['side_kernels']} kernels, {ov['side_busy_ms']:.3f} ms "
        f"busy over [{ov['side_span_ms'][0]:.3f}, {ov['side_span_ms'][1]:.3f}] ms; kernels of the two streams run "
        f"at the same time for {ov['overlap_ms']:.3f} ms: detection "
        f"{'overlaps' if ov['overlap_ms'] > 0 else 'does not overlap'} track_step")
    return launches


def drive_steered(cfg, dev, kernels: dict, expected: dict, slice_steady, card: str) -> dict:
    """The fifth path: the sparse path with steered BRIEF.  -> its launch counts."""
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, track_step
    from stereo_semantic_vo_tpu_torch.ops.orb import extract_orb

    n_s = N_STEER_FRAMES
    pipe, wall, poses, launches = drive_path("steered", cfg, dev, n_s, 0, kernels, expected)
    last = list(frames(cfg, n_s + 1))[-1]
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:5]))
    kp = extract_orb(frame.left, cfg.orb)
    angle = kp.angle[kp.valid]
    check(float(angle.abs().max()) > 0.5, "steered path: the keypoints carry no angle")
    say(f"steered: keypoint angles span [{float(angle.min()):.3f}, {float(angle.max()):.3f}] rad on frame {n_s}")
    no_sync("one steered track_step", lambda: track_step(pipe.state, frame, cfg))
    cpu_rerun("steered", cfg, N_STEER_CPU_FRAMES, poses)
    steady = steady_state("steered", pipe, n_s, wall, card)
    say("steered beside the sparse path in this call: median / p90 {:.3f} / {:.3f} against {:.3f} / {:.3f} "
        "ms/frame".format(*steady, *slice_steady))
    return launches


def compare_volume_modes(cfg, dev) -> None:
    """The whole-image modes on a frame's ORB keypoints against "strips" and
    B2 ("pallas"), timed, with the kernels one "volume" call launches."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import keypoint_origins, keypoint_stereo_costs_plain
    from stereo_semantic_vo_tpu_torch.ops.orb import extract_orb
    from stereo_semantic_vo_tpu_torch.ops.stereo import BIG, sparse_disparity, volume_costs

    H, W = cfg.camera.height, cfg.camera.width
    sc = cfg.stereo
    D, r = sc.max_disparity, sc.block_radius
    left, right = (torch.from_numpy(a).to(dev) for a in two_plane_frame_source(H, W)(3))
    kp = extract_orb(left, cfg.orb)
    cam = Camera.from_config(cfg.camera, dev)
    modes = ("strips", "pallas", "volume", "volume2")
    calls = {m: (lambda m=m: sparse_disparity(left, right, kp.uv, kp.valid, cam,
                                              dataclasses.replace(sc, sparse_mode=m))) for m in modes}
    out = {m: calls[m]() for m in modes}
    torch.cuda.synchronize()
    for a, b in (("volume", "volume2"), ("strips", "pallas")):
        check(all(torch.equal(x, y) for x, y in zip(out[a], out[b])), f"stereo modes {a} and {b} differ")
    shift = keypoint_origins(kp.uv, H, W, D, r)[3]
    inside = shift == 0
    err = 0.0
    for ref in ("strips", "pallas"):
        v, s_ = out["volume"], out[ref]
        check(torch.equal(v.valid[inside], s_.valid[inside]), f"volume and {ref}: valid masks differ")
        err = max(err, float((v.disparity[inside] - s_.disparity[inside]).abs().max()))
    check(err <= VOLUME_DISP_TOL_PX, f"volume vs strips / B2: disparities differ by {err} px")
    # at the left edge the clamped strip reads disparity d at d - shift
    vol = volume_costs(left, right, kp.uv, sc)
    y0, xl0, xr0, _ = keypoint_origins(kp.uv, H, W, D, r)
    strips = torch.flip(keypoint_stereo_costs_plain(left, right, y0, xl0, xr0, D, r, sc.color_weight, sc.grad_weight,
                                                    sc.color_trunc, sc.grad_trunc), (1,))
    edge = torch.nonzero(~inside).flatten().tolist()
    cost_err = 0.0
    for k in edge:
        sh = int(shift[k])
        a, b = strips[k, sh:], vol[k, : D - sh]
        check(bool((vol[k, D - sh:] == BIG).all()), "volume: an unaddressable disparity has a cost")
        cost_err = max(cost_err, float(((a - b).abs() / b.abs()).max()))
    check(cost_err <= VOLUME_COST_RTOL, f"edge keypoints: strips at d vs volume at d - shift differ by rtol {cost_err}")
    n_edge_differ = int((out["volume"].disparity[~inside] != out["strips"].disparity[~inside]).sum())
    ms = {m: median_ms(calls[m], reps=10, warmup=2) for m in modes}
    n_kernels, n_copies = device_events(calls["volume"])
    n_kernels2, _ = device_events(calls["volume2"])
    say(f"volume modes: {int(kp.valid.sum())} ORB keypoints at {W}x{H}; volume and volume2 equal; against strips "
        f"and B2 where the strip is not clamped ({int(inside.sum())} keypoints): valid equal, disparities within "
        f"{err:.3g} px (bound {VOLUME_DISP_TOL_PX}); at the left edge ({len(edge)} keypoints, x < D - 1 + r) strips' "
        f"cost at d is volume's at d - shift within rtol {cost_err:.3g}, and {n_edge_differ} of their disparities "
        f"differ (ROADMAP C)")
    say("volume modes card ms (CUDA events, median of 10): " + ", ".join(f"{m} {t:.3f}" for m, t in ms.items())
        + f"; one volume call launches {n_kernels} kernels and {n_copies} copies or fills, volume2 {n_kernels2}")


def device_busy(fn) -> tuple[float, float, int]:
    """Profile ``fn()``: -> (device busy ms, the union of its kernels',
    copies' and fills' intervals over every stream; host wall ms under the
    profiler, synchronized; kernels)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall, sum(e.get("cat") == "kernel" for e in events)


def dp_turn(cfg, dev, batch: list, B: int, capture: bool, kernels: dict) -> dict:
    """One run of the data-parallel tracker over ``batch`` (a FrameInput a
    step), stream s restarting from a fresh state at step s; the launch
    counters set to 0 just before it.  -> its step, outputs, final states,
    the states its last step took, launches and wall seconds over steps
    DP_TIMED_FROM on."""
    from stereo_semantic_vo_tpu_torch.engine.state import init_state
    from stereo_semantic_vo_tpu_torch.parallel.dp_tracker import batched_init_state, make_dp_tracker

    step = make_dp_tracker([dev], cfg, capture=capture)
    states = batched_init_state(cfg, B, [dev])
    outs = []
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    for s in range(len(batch)):
        if s == DP_TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if 0 < s < B:  # stream s restarts here
            states[s] = init_state(cfg, dev)
        prev = states
        states, out = step(states, batch[s])
        outs.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"capture": capture, "step": step, "states": states, "prev": prev, "outs": outs, "wall": wall,
            "launches": {name: k.launches for name, k in kernels.items()}}


def drive_dp(cfg, dev, kernels: dict, card: str) -> dict:
    """The data-parallel tracker at each B of ``DP_BATCHES``, eager and
    replaying each stream's CUDA graphs in turns (eager, graph, eager,
    graph): stream b sees the scene's frame t + DP_OFFSET * b and restarts
    (a fresh state) at step b.  Each run: exact launch counts, ground
    truth, every stream bit for bit its single-stream run, the last step
    rerun from the states it took (handed out by the step before, so
    every stream rewinds a step) bit for bit again and with no sync,
    frames/s, the device's idle share; under graphs the capture ms and
    pool of each stream.  -> the launch counts of the graph runs."""
    from stereo_semantic_vo_tpu_torch.engine.state import init_state
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, init_step, track_step
    from stereo_semantic_vo_tpu_torch.io.synthetic import camera_x, two_plane_frame_source

    H, W, nb, N = cfg.camera.height, cfg.camera.width, cfg.semantic.max_boxes, N_DP_STEPS
    src = two_plane_frame_source(H, W)
    total = {name: 0 for name in kernels}
    for B in DP_BATCHES:
        offsets = [DP_OFFSET * b for b in range(B)]
        batch = []
        for s in range(N):
            imgs = [src(s + o) for o in offsets]
            batch.append(FrameInput(*(torch.from_numpy(np.stack([im[j] for im in imgs])).to(dev) for j in (0, 1)),
                                    torch.zeros((B, nb, 4), device=dev), torch.zeros((B, nb), dtype=torch.bool,
                                                                                       device=dev)))
        # each stream's own single-stream run from its last start
        singles = []
        for b in range(B):
            st, seq = init_state(cfg, dev), []
            for s in range(b, N):
                st, o = (init_step if s == b else track_step)(st, FrameInput(*(x[b] for x in batch[s])), cfg)
                seq.append(o)
            singles.append(seq)
        tracks = B * N - (2 * B - 1)  # stream 0 inits once, every other stream twice
        expected = {name: 0 for name in kernels}
        expected.update(extract_patches=B * N, keypoint_stereo_costs=B * N, fused_best_match=2 * tracks)
        lines = []
        for capture in (False, True, False, True):
            run = dp_turn(cfg, dev, batch, B, capture, kernels)
            kind = "graph" if capture else "eager"
            outs, launches, step = run["outs"], run["launches"], run["step"]
            check(launches == expected, f"dp B={B} {kind}: kernel launches {launches}, expected {expected}")
            check(all(sg.capture == capture for sg in step.steps.values()), f"dp B={B} {kind}: capture")
            if capture:
                for name, v in launches.items():
                    total[name] += v
            poses = torch.stack([o.T_wc for o in outs]).cpu().numpy()  # (N, B, 4, 4)
            pos_err = rot_err = 0.0
            for b in range(B):
                x0 = camera_x(b + offsets[b], cfg.camera.bf, cfg.camera.fx)
                for s in range(b, N):
                    gt = camera_x(s + offsets[b], cfg.camera.bf, cfg.camera.fx) - x0
                    pos_err = max(pos_err, float(np.linalg.norm(poses[s, b, :3, 3] - [gt, 0.0, 0.0])))
                    rot_err = max(rot_err, rotation_angle(poses[s, b, :3, :3]))
                    check(s == b or bool(outs[s].pnp_ok[b]), f"dp B={B} {kind}: stream {b} lost at step {s}")
                    for name, x in zip(singles[b][s - b]._fields, singles[b][s - b]):
                        check(torch.equal(getattr(outs[s], name)[b], x),
                              f"dp B={B} {kind}: stream {b} step {s} {name} differs from its single-stream run")
            check(pos_err <= POS_BOUND_M and rot_err <= ROT_BOUND_RAD,
                  f"dp B={B} {kind}: error {pos_err:.4f} m / {rot_err:.5f} rad against ground truth")
            states, again = run["states"], []
            no_sync(f"one dp step at B={B} ({kind}), every stream rewound a step",
                    lambda: again.append(step(run["prev"], batch[-1])[1]))
            for name, x, y in zip(outs[-1]._fields, outs[-1], again[0]):
                check(torch.equal(x, y), f"dp B={B} {kind}: the last step rerun from the states it took "
                                         f"differs in {name}")
            busy, wall_p, n_k = device_busy(lambda: [step(states, batch[s]) for s in range(N - 3, N)])
            timed, wall = N - DP_TIMED_FROM, run["wall"]
            graphs = [g for sg in step.steps.values() if sg.capture for g in sg.graphs.values() if g.graph is not None]
            cap = (f"; capture {sum(g.capture_ms for g in graphs) / B:.1f} ms and graph pool "
                   f"{sum(g.pool_bytes for g in graphs) / B / 2**20:.1f} MiB a stream" if capture else "")
            lines.append(f"dp B={B} {kind}: {B * timed / wall:.3f} frames/s in all, {wall / timed * 1e3:.3f} ms a step "
                         f"(a frame of each stream) over steps {DP_TIMED_FROM}-{N - 1}; under the profiler (3 steps) "
                         f"device busy {busy / 3:.3f} ms a step of {wall_p / 3:.3f} ms, idle "
                         f"{100 * (1 - busy / wall_p):.1f}%, {n_k / 3:.0f} kernels a step{cap}; card {card}")
            del run, outs, step, states
            torch.cuda.empty_cache()
        say(f"dp B={B}: {N} steps, streams restarting at steps {list(range(B))}, eager and graph runs in turns, "
            f"every stream of every run bit for bit its single-stream run and again when rewound a step, max error "
            f"{pos_err:.5f} m / "
            f"{rot_err:.6f} rad; launches {launches}")
        for line in lines:
            say(line)
    return total


def drive_sharded(cfg, dev, kernels: dict, expected: dict, card: str) -> dict:
    """The landmark-sharded window BA over NCCL at world size 1, in this
    process: the runner against ``local_ba``, then the runner and the mesh
    pipeline eager and replaying their CUDA graphs (the collectives inside
    the capture) in turns.  -> the launch counts of the pipeline with a
    mesh."""
    import socket

    import torch.distributed as dist

    from stereo_semantic_vo_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(device=dev.type)
        check(mesh.device == dev and mesh.size == 1, f"mesh {mesh}")
        sharded_solve_turns(cfg, dev, mesh, card)
        # the pipeline with the mesh, against the same pipeline without one
        n_f = N_SHARDED_FRAMES
        pipe, _, poses_m, launches = drive_path("sharded window BA", cfg, dev, n_f, 1, kernels, expected,
                                                ba_mesh=mesh)
        check(pipe.window_ba is not None and pipe.steps.window_ba is pipe.window_ba, "the pipeline did not take the mesh")
        ref, _ = run_slice(cfg, dev, n_f, local_ba_every=1)
        poses_r = np.stack([o.T_wc.cpu().numpy() for o in ref.outputs])
        dpos = float(np.abs(poses_m[:, :3, 3] - poses_r[:, :3, 3]).max())
        drot = max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(poses_m, poses_r))
        check(dpos <= CPU_POS_TOL_M and drot <= CPU_ROT_TOL_RAD,
              f"pipeline with a mesh vs without: poses differ by {dpos} m / {drot} rad")
        no_sync("one eager sharded refine", lambda: pipe.window_ba.refine(pipe.state, pipe._n_processed))
        say(f"VOPipeline(ba_mesh=..., local_ba_every=1) vs no mesh: {n_f} frames, {n_f - 3} refines, max pose "
            f"difference {dpos:.3g} m, {drot:.3g} rad; card {card}")
        del pipe, ref
        mesh_pipeline_turns(cfg, dev, mesh, kernels, card)
    finally:
        gc.collect()  # the graphs that hold the group's collectives go before the group
        torch.cuda.synchronize()
        dist.destroy_process_group()
    return launches


def sharded_solve_turns(cfg, dev, mesh, card: str) -> None:
    """The sharded runner on ``local_ba_problem`` against ``local_ba`` (B7
    build), then eager and replaying its graph in turns, each solve bit for
    bit the first eager one; ms, kernels, capture ms and pool, no sync in a
    replay."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.ops.local_ba import local_ba
    from stereo_semantic_vo_tpu_torch.parallel.sharded_ba import make_sharded_local_ba

    cam = Camera.from_config(cfg.camera, dev)
    poses, X, obs, mask, ur, rm = local_ba_problem(cfg.camera, dev, cfg.window.window_frames,
                                                   cfg.window.max_map_points)
    X0, pv = X + 0.1, torch.ones(X.shape[0], dtype=torch.bool, device=dev)
    args = (poses, X0, obs, mask, pv, ur, rm)
    run = make_sharded_local_ba(mesh, cam, cfg.ba, stereo_edges=True)
    got = run(*args)
    want = local_ba(poses, X0, obs, mask, pv, cam, cfg.ba, obs_ur=ur, obs_r_mask=rm)
    dcost = abs(float(got.cost) - float(want.cost)) / abs(float(want.cost))
    dpose = float((got.poses - want.poses).abs().max())
    dpt = float(torch.median(torch.linalg.vector_norm(got.points - want.points, dim=1)))
    check(dcost <= SHARDED_COST_RTOL and dpose <= SHARDED_POSE_ATOL and dpt < SHARDED_POINT_MEDIAN_M,
          f"sharded BA vs local_ba: cost rtol {dcost}, poses {dpose}, median point {dpt} m")
    ms_local = median_ms(lambda: local_ba(poses, X0, obs, mask, pv, cam, cfg.ba, obs_ur=ur, obs_r_mask=rm),
                         reps=10, warmup=2)
    say(f"sharded BA over NCCL, world size {mesh.size}: F=4, L=2048, stereo edges against local_ba (B7 build): cost "
        f"rtol {dcost:.3g}, poses max abs {dpose:.3g}, median point {dpt:.3g} m (bounds {SHARDED_COST_RTOL}, "
        f"{SHARDED_POSE_ATOL}, {SHARDED_POINT_MEDIAN_M}); local_ba {ms_local:.3f} ms a solve")
    # the runner eager and replaying its graph, in turns
    turns = []
    for capture in (False, True, False, True):
        r = make_sharded_local_ba(mesh, cam, cfg.ba, stereo_edges=True, capture=capture)
        out = r(*args) if not capture else (r(*args), r(*args))[1]  # a graph's first call warms up and captures
        turns.append((capture, r, out, median_ms(lambda: r(*args), reps=10, warmup=2)))
    for capture, r, out, _ in turns:
        check(all(torch.equal(a, b) for a, b in zip(out, turns[0][2])),
              f"sharded solve {'graph' if capture else 'eager'}: differs from the first eager solve")
    graph_run = turns[-1][1]
    (g, _), = graph_run.graphs.values()
    check(g.replays > 0 and all(torch.equal(a, b) for a, b in zip(turns[-1][2], got)),
          "sharded solve: the graph did not replay, or differs from the solve checked against local_ba")
    no_sync("one replay of the sharded solve's graph (NCCL all-reduces inside)", lambda: graph_run(*args))
    k_e, c_e = device_events(lambda: turns[-2][1](*args))
    k_g, c_g = device_events(lambda: graph_run(*args))
    say(f"sharded solve eager and graph in turns, each bit for bit the first eager solve: ms a solve (CUDA "
        "events, median of 10) " + ", ".join(f"{'graph' if c else 'eager'} {ms:.3f}" for c, _, _, ms in turns)
        + f"; kernels and copies a solve eager {k_e} + {c_e}, graph {k_g} + {c_g}; capture {g.capture_ms:.1f} "
        f"ms, graph pool {g.pool_bytes / 2**20:.1f} MiB, {g.replays} replays; card {card}")


def mesh_pipeline_turns(cfg, dev, mesh, kernels: dict, card: str) -> None:
    """``VOPipeline(ba_mesh=..., local_ba_every=1)`` eager and replaying its
    graphs (the refine's holds the collectives), in turns: each graph run
    bit for bit the eager runs, with their launches and a refine graph
    replayed on every refine frame after the first; then ms a refine (10
    more on each run's last state), kernels a refine, capture ms and pool
    MiB, and a replayed refine without a sync."""
    n_f, win = N_SHARDED_FRAMES, cfg.window.window_frames
    turns = []
    for capture in (False, True, False, True):
        for k in kernels.values():
            k.launches = 0
        pipe, _ = run_slice(cfg, dev, n_f, local_ba_every=1, ba_mesh=mesh, capture=capture)
        check(pipe.steps.capture == capture, f"mesh pipeline: capture {pipe.steps.capture}")
        steady = np.array(pipe.frame_times[win:]) * 1e3
        turns.append((capture, pipe, {name: k.launches for name, k in kernels.items()}, float(np.median(steady))))
    eager = [t for t in turns if not t[0]]
    check(same_run(eager[0][1], eager[1][1]), "mesh pipeline: two eager runs differ")
    for capture, pipe, launches, _ in turns:
        if capture:
            check(same_run(eager[0][1], pipe), "mesh pipeline: a graph run differs from the eager run")
            check(launches == eager[0][2], f"mesh pipeline: launches {launches} under graphs, {eager[0][2]} eager")
            g = pipe.steps.graphs["refine_state"]
            check(g.replays == n_f - win, f"mesh pipeline: {g.replays} refine replays, expected {n_f - win}")
    refine_ms = [median_ms(pipe.steps.refine, reps=10, warmup=2) for _, pipe, _, _ in turns]
    k_e, c_e = device_events(turns[-2][1].steps.refine)
    k_g, c_g = device_events(turns[-1][1].steps.refine)
    pipe = turns[-1][1]
    no_sync("one replay of the mesh pipeline's refine graph (NCCL all-reduces and all-gather inside)",
            pipe.steps.refine)
    g = pipe.steps.graphs["refine_state"]
    say(f"mesh pipeline eager and graph in turns: {n_f} frames, refine every frame from frame {win - 1}, each graph "
        f"run bit for bit the eager runs (outputs of every frame, final state) with their launches, the refine "
        f"graph replayed {n_f - win} times a run; ms a refine (CUDA events, median of 10) " + ", ".join(
            f"{'graph' if c else 'eager'} {ms:.3f}" for (c, _, _, _), ms in zip(turns, refine_ms))
        + "; host ms/frame median over frames {}-{} ".format(win, n_f - 1) + ", ".join(
            f"{'graph' if c else 'eager'} {med:.3f}" for c, _, _, med in turns)
        + f"; kernels and copies a refine eager {k_e} + {c_e}, graph {k_g} + {c_g}; refine graph capture "
        f"{g.capture_ms:.1f} ms, pool {g.pool_bytes / 2**20:.1f} MiB; card {card}")


def compare_replicated_detector(cfg, dev, det, card: str) -> None:
    """The replicated detector on the card's data axis: a replayed batch of
    two frames against ``det.detect`` of each; then batches of 2 and 4
    frames eager and replaying the device's graph in turns, each graph
    batch bit for bit the eager one, timed, without a sync in a replay."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.models import zoo
    from stereo_semantic_vo_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from stereo_semantic_vo_tpu_torch.parallel.semantic_head import make_replicated_detector

    H, W = cfg.camera.height, cfg.camera.width
    src = two_plane_frame_source(H, W)
    gray = [torch.from_numpy(src(i)[0] / 255.0).to(dev) for i in (0, 5, 10, 15)]
    imgs = torch.stack([torch.stack([g, g, g], -1) for g in gray])
    mesh = make_mesh(1, axis=DATA_AXIS, device=dev.type)
    detect = make_replicated_detector(mesh, zoo.KITTI_TINY_V2_CFG, img_hw=(H, W))
    detect(imgs[:2])  # warms up and captures
    out = detect(imgs[:2])
    check(detect.graphs[0, 2][0].replays == 1, "replicated detector: the batch of 2 did not replay")
    box_err = 0.0
    for b, img in enumerate(imgs[:2]):
        want = det.detect(img)
        check(torch.equal(out.valid[b], want.valid), f"replicated detector: valid differs on frame {b}")
        v = want.valid
        box_err = max(box_err, float((out.boxes[b][v] - want.boxes[v]).abs().max()))
        check(torch.allclose(out.scores[b], want.scores, rtol=DET_RTOL, atol=0.0),
              f"replicated detector: scores differ on frame {b}")
    check(box_err <= DET_BOX_TOL_PX, f"replicated detector: boxes differ by {box_err} px")
    say(f"replicated detector: a replayed batch of 2 frames on {[str(d) for d in mesh.devices]} against detect of "
        f"each: valid equal ({[int(x) for x in out.valid.sum(1)]} boxes), boxes within {box_err:.3g} px, scores "
        f"within rtol {DET_RTOL}")
    for B in (2, 4):
        x, turns = imgs[:B], []
        for capture in (False, True, False, True):
            d = make_replicated_detector(mesh, zoo.KITTI_TINY_V2_CFG, img_hw=(H, W), capture=capture)
            o = d(x) if not capture else (d(x), d(x))[1]
            turns.append((capture, d, o, median_ms(lambda: d(x), reps=20)))
        for capture, d, o, _ in turns:
            check(all(torch.equal(a, b) for a, b in zip(o, turns[0][2])),
                  f"replicated detector B={B} {'graph' if capture else 'eager'}: differs from the first eager batch")
        d = turns[-1][1]
        (g, static), = d.graphs.values()
        check(tuple(static.shape) == (B, H, W, 3) and g.replays > 0, f"replicated detector B={B}: graph {static.shape}")
        no_sync(f"one replayed replicated detect of {B} frames", lambda: d(x))
        k_e, c_e = device_events(lambda: turns[-2][1](x))
        k_g, c_g = device_events(lambda: d(x))
        say(f"replicated detector B={B} eager and graph in turns, each batch bit for bit the first eager batch: ms a "
            "batch (CUDA events, median of 20) " + ", ".join(f"{'graph' if c else 'eager'} {ms:.3f}"
                                                            for c, _, _, ms in turns)
            + f"; kernels and copies a batch eager {k_e} + {c_e}, graph {k_g} + {c_g}; capture {g.capture_ms:.1f} ms, "
            f"graph pool {g.pool_bytes / 2**20:.1f} MiB; card {card}")


def train_pool(cfg, net: int, dev) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first N_TRAIN_POOL smoke frames letterboxed to net x net by the
    replay-training tool's ``to_net``, with their boxes as its
    ``boxes_to_truths`` makes them (MAX_T slots), on ``dev``."""
    from stereo_semantic_vo_tpu_torch.tools.train_replay_detector import boxes_to_truths, to_net

    H, W = cfg.camera.height, cfg.camera.width
    imgs, truths, masks = [], [], []
    for _, left, _, boxes, valid, _ in frames(cfg, N_TRAIN_POOL):
        imgs.append(to_net(left, net, net))
        t, m = boxes_to_truths(boxes, valid, W, H, net, net)
        truths.append(t)
        masks.append(m)
    return tuple(torch.from_numpy(np.stack(a)).to(dev) for a in (imgs, truths, masks))


def train_batch(pool, s: int) -> tuple[torch.Tensor, ...]:
    """Step s's batch: pool entries 8s .. 8s + 7, cycling."""
    idx = torch.arange(s * TRAIN_BATCH, (s + 1) * TRAIN_BATCH, device=pool[0].device) % pool[0].shape[0]
    return tuple(a.index_select(0, idx) for a in pool)


def compare_trainers(label: str, gpu, cpu) -> tuple[float, float]:
    """Every param, rolling statistic and momentum buffer of the card's
    trainer against the CPU's.  -> the worst leaf's difference over its
    L2 norm, and over its max |CPU| (for the record)."""
    a, b = gpu.state, cpu.state
    check((int(a.batch_num), int(a.seen)) == (int(b.batch_num), int(b.seen)), f"{label}: counters differ")
    worst_l2, worst_max = 0.0, 0.0
    for tree in ("params", "momentum"):
        for li, leaves in getattr(b, tree).items():
            for k, want in leaves.items():
                d = getattr(a, tree)[li][k].cpu().double() - want.double()
                norm, top = float(want.double().norm()), float(want.abs().max())
                if norm == 0.0:  # a leaf still at zero (no step has moved it) is zero on both
                    check(float(d.abs().max()) == 0.0, f"{label}: {tree} of layer {li} {k} is zero on the CPU only")
                    continue
                l2 = float(d.norm()) / norm
                worst_l2, worst_max = max(worst_l2, l2), max(worst_max, float(d.abs().max()) / top)
                check(l2 <= TRAIN_LEAF_L2_RTOL, f"{label}: {tree} of layer {li} {k} differs by {l2:.3g} of its norm")
    return worst_l2, worst_max


def leaf_spread(a, b) -> tuple[float, str]:
    """The largest difference between two trainers' params, statistics and
    momentum, over the leaf's max |a| (0.0: bit for bit).  -> (it, the
    leaf it is found in)."""
    worst, where = 0.0, "none"
    for tree in ("params", "momentum"):
        for li, leaves in getattr(a, tree).items():
            for k, x in leaves.items():
                d = float((x - getattr(b, tree)[li][k]).abs().max())
                top = float(x.abs().max())
                if (d / top if top else d) > worst:
                    worst, where = d / top if top else d, f"{tree} of layer {li} {k} (max |x| {top:.3g})"
    return worst, where


def start_near_burn_in(tr) -> None:
    """Put ``tr``'s counters TRAIN_START_BEFORE steps short of the end of
    its learning rate's burn-in and of the region burn-in's 12800 images
    seen, so that a run's steps cross both and a graph that froze either
    would show."""
    from stereo_semantic_vo_tpu_torch.models.yolo_train import BURN_IN_SEEN

    burn_in = int(tr.net_sec.get("burn_in", 0))
    check(burn_in > TRAIN_START_BEFORE, f"burn_in {burn_in}")
    tr.load_state(tr.state._replace(batch_num=torch.tensor(burn_in - TRAIN_START_BEFORE, dtype=torch.int32),
                                    seen=torch.tensor(BURN_IN_SEEN - TRAIN_START_BEFORE * TRAIN_BATCH,
                                                      dtype=torch.int32)))


@contextlib.contextmanager
def cudnn_deterministic():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def train_turn(label: str, text: str, dev, pool, n_steps: int, capture: bool, cpu=None, n_cpu: int = 0,
               near_burn_in: bool = True) -> dict:
    """``n_steps`` steps of a trainer from seed 0 on the card, its
    counters put near the burn-ins' ends (``start_near_burn_in``) unless
    ``near_burn_in`` is False, eager or replaying its step's graph, the
    first ``n_cpu`` also on ``cpu`` (a trainer on the host CPU, started
    alike): the losses finite and against the CPU's, no sync in step 3's
    dispatch.  -> the trainer, its losses, each step's CUDA-event ms and
    the CPU comparison."""
    from stereo_semantic_vo_tpu_torch.models.yolo_train import YoloTrainer

    kind = "graph" if capture else "eager"
    tr = YoloTrainer(text, seed=0, device=dev, capture=capture)
    check(tr.capture == capture, f"{label} {kind}: capture {tr.capture}")
    if near_burn_in:
        start_near_burn_in(tr)
    b0, s0 = tr.batch_num, tr.seen
    pool_cpu = tuple(a.cpu() for a in pool) if cpu is not None else None
    losses, times, loss_err, leaves = [], [], 0.0, None
    for s in range(n_steps):
        batch = train_batch(pool, s)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        if s == 3:  # one step's dispatch under sync debug mode; its loss is read after
            no_sync(f"{label}: one train step's dispatch ({kind})", lambda: losses.append(tr.step(*batch)[0]))
            losses[-1] = float(losses[-1])
        else:
            losses.append(tr.train_step(*batch)[0])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        check(math.isfinite(losses[-1]), f"{label} {kind}: loss {losses[-1]} at step {s}")
        if s < n_cpu:
            lc = cpu.train_step(*train_batch(pool_cpu, s))[0]
            loss_err = max(loss_err, abs(losses[-1] - lc) / abs(lc))
            check(loss_err <= TRAIN_LOSS_RTOL,
                  f"{label} {kind}: step {s} loss {losses[-1]} on the card, {lc} on the CPU")
            if s == n_cpu - 1:
                leaves = compare_trainers(label, tr, cpu)
    check(tr.seen == s0 + n_steps * TRAIN_BATCH and tr.batch_num == b0 + n_steps,
          f"{label} {kind}: seen {tr.seen}, batch_num {tr.batch_num} after {n_steps} steps from {s0}, {b0}")
    return {"trainer": tr, "losses": losses, "times": times, "loss_err": loss_err, "leaves": leaves}


def graph_against_eager(label: str, eager: list, graph: list) -> tuple[tuple[float, str], tuple[float, str]]:
    """Each graph run as close to an eager run as the eager runs come to
    each other, and its losses the eager runs' where those are bit for
    bit.  -> (the eager runs' largest pairwise difference, the largest
    distance of a graph run from its nearest eager run), each with its
    leaf."""
    spread = max((leaf_spread(a["trainer"].state, b["trainer"].state) for i, a in enumerate(eager)
                  for b in eager[i + 1:]), key=lambda x: x[0])
    worst = max((min((leaf_spread(e["trainer"].state, g["trainer"].state) for e in eager), key=lambda x: x[0])
                 for g in graph), key=lambda x: x[0])
    check(worst[0] <= spread[0], f"{label}: a graph run lies {worst[0]:.3g} of a leaf's max from the nearest eager "
                                 f"run ({worst[1]}), the eager runs up to {spread[0]:.3g} from each other")
    check(all(g["losses"] == eager[0]["losses"] for g in graph) or spread[0] > 0,
          f"{label}: the graph runs' losses differ from the eager runs'")
    return spread, worst


def drive_trainer(label: str, cfg, dev, cfg_text: str, n_steps: int, n_cpu: int, card: str):
    """Train ``cfg_text`` (with the replay tool's training lines) for
    ``n_steps`` steps of TRAIN_BATCH smoke frames on the card, eager and
    replaying the step's CUDA graph in turns (eager, graph, eager, graph,
    eager, eager), every run started near the burn-ins' ends
    (``start_near_burn_in``); before them a graph run of ``n_cpu`` steps
    from the seed's state, which the host CPU repeats (near the burn-ins'
    ends the learning rate is near its full value, where at step 0 it is
    ~0, and the float32 gradients' difference between card and CPU,
    moved by it, makes step 1's loss differ by ~1e-4 of itself on an
    H100).  Each graph run as close to an eager run as the eager runs
    come to each other (their largest pairwise difference; bit for bit
    where they are); then two eager and two graph runs of
    N_DET_TRAIN_STEPS steps under cuDNN's deterministic algorithms, where
    the graph runs equal the eager runs bit for bit if those equal each
    other; ms a step, images/s, kernels and busy share of each kind.  ->
    the first graph run's trainer."""
    from torch.utils.flop_counter import FlopCounterMode

    from stereo_semantic_vo_tpu_torch.models.yolo_train import YoloTrainer, learning_rate
    from stereo_semantic_vo_tpu_torch.tools.train_replay_detector import MAX_T, train_cfg

    text = train_cfg(cfg_text)
    cpu = YoloTrainer(text, seed=0, device="cpu")
    check(cpu.net_w == cpu.net_h and cpu.batch == 1, f"{label}: net {cpu.net_w}x{cpu.net_h}, batch {cpu.batch}")
    pool = train_pool(cfg, cpu.net_w, dev)
    check(pool[1].shape[1] == MAX_T and bool(pool[2].any()), f"{label}: no truth in the pool")
    ref = train_turn(label, text, dev, pool, n_cpu, True, cpu, n_cpu, near_burn_in=False)
    turns = [train_turn(label, text, dev, pool, n_steps, capture)
             for capture in (False, True, False, True, False, False)]
    eager = [t for t in turns if not t["trainer"].capture]
    graph = [t for t in turns if t["trainer"].capture]
    spread, worst = graph_against_eager(label, eager, graph)
    with cudnn_deterministic():
        det = [train_turn(f"{label} deterministic", text, dev, pool, N_DET_TRAIN_STEPS, capture)
               for capture in (False, True, False, True)]
    det_spread, det_worst = graph_against_eager(f"{label} deterministic", [det[0], det[2]], [det[1], det[3]])
    gpu = graph[0]["trainer"]
    leaf_l2, leaf_max = ref["leaves"]
    b_end = gpu.batch_num
    lrs = [learning_rate(gpu.net_sec, b) for b in range(b_end - n_steps, b_end)]
    batch = train_batch(pool, 0)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        gpu.net(batch[0][:1].permute(0, 3, 1, 2).contiguous())
    step_flops = 3.0 * fc.get_total_flops() * TRAIN_BATCH
    bound_ms = step_flops / FP32_FLOP_PER_S * 1e3
    say(f"{label} training: {n_steps} steps of {TRAIN_BATCH} images {gpu.net_w}x{gpu.net_h} on the card, eager and "
        f"graph in turns, loss {graph[0]['losses'][0]:.3f} -> {graph[0]['losses'][-1]:.3f}, finite at every step, "
        f"from seen "
        f"{gpu.seen - n_steps * TRAIN_BATCH} and batch_num {b_end - n_steps} to {gpu.seen} and {b_end} (learning "
        f"rate {lrs[0]:.4g} -> {lrs[-1]:.4g}, the region burn-in on in the first {TRAIN_START_BEFORE} steps); "
        f"each graph run within {worst[0]:.3g} of a leaf's max of an eager run ({worst[1]}), {len(eager)} eager "
        f"runs up to {spread[0]:.3g} from each other ({spread[1]}; "
        f"{'bit for bit' if spread[0] == 0 else 'not bit for bit'}); under cuDNN's deterministic algorithms "
        f"({N_DET_TRAIN_STEPS} steps, 2 eager and 2 graph runs) the eager runs {det_spread[0]:.3g} apart "
        f"({det_spread[1]}), each graph run within {det_worst[0]:.3g} of an eager run ({det_worst[1]}); "
        f"a graph run of {n_cpu} steps from the seed's state against the CPU: loss rtol {ref['loss_err']:.3g} "
        f"(bound {TRAIN_LOSS_RTOL}), every leaf "
        f"within {leaf_l2:.3g} of its norm (bound {TRAIN_LEAF_L2_RTOL}; the worst element {leaf_max:.3g} of the "
        f"leaf's max)")
    for t in turns:
        tr = t["trainer"]
        kind = "graph" if tr.capture else "eager"
        times = t["times"]
        timed = times[TRAIN_TIMED_FROM:] if n_steps > TRAIN_TIMED_FROM + 2 else times[1:]
        ms = float(np.median(timed))
        n_k, n_c = device_events(lambda: tr.step(*batch))
        busy, wall, _ = device_busy(lambda: tr.train_step(*batch))
        cap = ""
        if tr.capture:
            (g, _), = tr.graphs.values()
            cap = f"; capture {g.capture_ms:.1f} ms, graph pool {g.pool_bytes / 2**20:.1f} MiB"
        say(f"{label} training {kind}: {ms:.3f} ms a step (CUDA-event median over steps {len(times) - len(timed)}-"
            f"{n_steps - 1}), {TRAIN_BATCH / ms * 1e3:.1f} images/s, {n_k} kernels and {n_c} copies or fills a step; "
            f"profiled step: device busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%, idle "
            f"{100 * (1 - busy / wall):.1f}%); conv {fc.get_total_flops() / 1e9:.3f} GFLOP an image forward, "
            f"{step_flops / 1e9:.2f} GFLOP a step (3x forward), bound {bound_ms:.3f} ms at "
            f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s float32: {100 * bound_ms / ms:.1f}% of the peak{cap}; card {card}")
    train_breakdown(label, eager[-1]["trainer"], batch, card)
    return gpu


def train_breakdown(label: str, tr, batch, card: str) -> None:
    """Where a training step's time goes: kernels and card ms (CUDA-event
    medians of the dispatch, which the host bounds) of the net's forward
    pass, then with the losses, then of the whole step; the differences
    are the losses' and the backward pass with the update's."""
    from stereo_semantic_vo_tpu_torch.core.precision import f32_matmul

    x = batch[0].permute(0, 3, 1, 2).contiguous()
    parts = {"forward": lambda: tr.net(x), "forward + loss": lambda: tr.loss(x, batch[1], batch[2]),
             "step": lambda: tr.step(*batch)}
    got = {}
    for name, fn in parts.items():
        with f32_matmul():
            got[name] = (device_events(fn)[0], median_ms(fn, reps=10, warmup=2))
    (kf, tf), (kl, tl), (ks, ts) = got.values()
    slots = batch[1].shape[1] * tr.net.n_heads
    say(f"{label} step breakdown: forward {kf} kernels {tf:.3f} ms; losses {kl - kf} kernels {tl - tf:.3f} ms "
        f"({(kl - kf) / slots:.1f} kernels a truth slot and head, {slots} of them); backward and update "
        f"{ks - kl} kernels {ts - tl:.3f} ms; the step {ks} kernels {ts:.3f} ms (card ms: CUDA events around "
        f"the dispatch); card {card}")


def compare_exported_detector(cfg, dev, tr, cfg_text: str) -> None:
    """``export_weights`` loaded by ``YoloDetector`` against
    ``folded_params`` through ``from_params``, on the card: equal
    detections on smoke frame 0."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector
    from stereo_semantic_vo_tpu_torch.tools.train_replay_detector import train_cfg

    text = train_cfg(cfg_text)
    img = torch.from_numpy(two_plane_frame_source(cfg.camera.height, cfg.camera.width)(0)[0] / 255.0).to(dev)
    a = YoloDetector(text, weights_bytes=tr.export_weights(), conf_threshold=0.01, device=dev).detect(img)
    b = YoloDetector.from_params(text, tr.folded_params(), conf_threshold=0.01, device=dev).detect(img)
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "exported weights and folded params detect differently")
    say(f"trained kitti_tiny_v2: export_weights -> YoloDetector(weights_bytes=...) equals "
        f"YoloDetector.from_params(folded_params()) on the card, {int(b.valid.sum())} boxes at conf 0.01")


def resume_from_checkpoint(cfg, dev, slice_poses: np.ndarray) -> None:
    """The sparse path for N_RESUME_AT frames, a checkpoint, a fresh
    pipeline resumed from it on frames N_RESUME_AT .. N_RESUME_FRAMES - 1:
    its poses bit for bit the uninterrupted first path's; then one frame
    under ``device_trace``."""
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
    from stereo_semantic_vo_tpu_torch.utils.checkpoint import load_state, save_state
    from stereo_semantic_vo_tpu_torch.utils.profiling import device_trace

    seq = list(frames(cfg, N_RESUME_FRAMES + 1))
    first = VOPipeline(cfg, device=dev, write_trajectory=False)
    first.run(iter(seq[:N_RESUME_AT]), prefetch=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        save_state(path, first.state)
        save_ms, size = (time.perf_counter() - t0) * 1e3, os.path.getsize(path)
        second = VOPipeline(cfg, device=dev, write_trajectory=False)
        t0 = time.perf_counter()
        second.resume(load_state(path, second.state))
        load_ms = (time.perf_counter() - t0) * 1e3
    check(int(second.state.frame_idx) == N_RESUME_AT - 1 and second.state.T_cw.device == dev,
          f"resumed state at frame {int(second.state.frame_idx)} on {second.state.T_cw.device}")
    second.run(iter(seq[N_RESUME_AT:N_RESUME_FRAMES]), prefetch=False)
    poses = np.stack([o.T_wc.cpu().numpy() for o in first.outputs + second.outputs])
    check(poses.shape[0] == N_RESUME_FRAMES and np.array_equal(poses, slice_poses[:N_RESUME_FRAMES]),
          "resumed poses differ from the uninterrupted run's")
    say(f"checkpoint: sparse path saved after frame {N_RESUME_AT - 1} ({size} bytes, {save_ms:.1f} ms), loaded into "
        f"a fresh pipeline ({load_ms:.1f} ms) that tracked frames {N_RESUME_AT}-{N_RESUME_FRAMES - 1}: poses bit "
        f"for bit the first path's")
    _, left, right, boxes, valid, ts = seq[N_RESUME_FRAMES]
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            second.process_frame(left, right, boxes, valid, ts)
            torch.cuda.synchronize()
        files = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        check(len(files) == 1 and files[0].endswith(".pt.trace.json"), f"device_trace wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        n_kernels = sum(e.get("cat") == "kernel" for e in events)
        check(n_kernels > 0, "the trace of a frame holds no kernel")
        say(f"device_trace: one sparse frame under torch.profiler wrote {os.path.basename(files[0])}, "
            f"{os.path.getsize(files[0])} bytes, {len(events)} events, {n_kernels} kernels")


def write_kitti_sequence(seq: str, frame_iter, fps: float, boxes_dir: str | None = None) -> int:
    """Write (idx, left, right, boxes, valid, ts) frames as a KITTI sequence
    directory: ``image_2/`` and ``image_3/`` 8-bit PNGs named by frame and
    ``times.txt``; with ``boxes_dir``, each frame's valid boxes in the
    reference's files (``<frame+1>.txt``, integer rows ``left right top
    bottom``; a frame without one writes no file).  -> the frame count."""
    from PIL import Image

    for side in ("image_2", "image_3"):
        os.makedirs(os.path.join(seq, side))
    if boxes_dir is not None:
        os.makedirs(boxes_dir)
    n = 0
    for t, left, right, boxes, valid, _ in frame_iter:
        for side, img in (("image_2", left), ("image_3", right)):
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(seq, side, f"{t:06d}.png"))
        if boxes_dir is not None and valid.any():
            with open(os.path.join(boxes_dir, f"{t + 1}.txt"), "w") as f:
                f.writelines(f"{x1} {x2} {y1} {y2}\n" for x1, y1, x2, y2 in boxes[valid].astype(int))
        n += 1
    np.savetxt(os.path.join(seq, "times.txt"), np.arange(n) / fps)
    return n


def native_loader_state(cfg) -> None:
    """Whether the native loader builds here; PNGs of the scene through it
    (where it builds) and through ``iter_frames(..., image_hw=...)``."""
    from stereo_semantic_vo_tpu_torch.io import kitti, native_loader

    H, W, n = cfg.camera.height, cfg.camera.width, 4
    ok = native_loader.available()
    say(f"native loader: available() = {ok}" + ("" if ok else f"; why: {native_loader.why_unavailable()}"))
    with tempfile.TemporaryDirectory() as seq:
        write_kitti_sequence(seq, frames(cfg, n), cfg.camera.fps)
        paths = kitti.load_sequence_paths(seq)
        want = [(kitti.load_image_gray(a), kitti.load_image_gray(b)) for a, b in zip(paths.left, paths.right)]
        if ok:
            for t in range(n):
                check(np.array_equal(native_loader.decode_gray(paths.left[t], H, W), want[t][0]),
                      f"native decode of frame {t} differs from Pillow's")
        got = list(kitti.iter_frames(paths, None, cfg.semantic.max_boxes, image_hw=(H, W)))
        check([g[0] for g in got] == list(range(n)), "iter_frames out of order")
        for g, (left, right) in zip(got, want):
            check(np.array_equal(g[1], left) and np.array_equal(g[2], right), f"iter_frames frame {g[0]} differs")
    say(f"native loader: {n} stereo PNG pairs of the scene at {W}x{H} through iter_frames(..., image_hw=({H}, {W})) "
        f"in order and equal to Pillow's decode, on the " + ("native prefetcher" if ok else "Pillow fallback")
        + (", and decode_gray of each equal to Pillow's" if ok else ""))


def mover_frames(cfg, n: int):
    """(idx, left, right, boxes, boxes_valid, timestamp) of the two-plane
    scene with a moving object: a MOVER_PX square of random texture at the
    far plane's disparity, MOVER_VY_PX px lower each frame (off the
    horizontal epipolar lines of the sideways-moving camera), under a box 5
    px outside it, as tests/test_semantic_culling.py draws its mover.  The
    box is missed on frames t % MOVER_MISS_EVERY == 0, as a late detector
    misses: map points are created on the object then, and the epipolar
    test has them to cull in the frames that follow."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import D_FAR, two_plane_frame_source

    src = two_plane_frame_source(cfg.camera.height, cfg.camera.width)
    obj = np.random.RandomState(7).uniform(0, 255, (MOVER_PX, MOVER_PX)).astype(np.float32)
    nb, x = cfg.semantic.max_boxes, MOVER_X
    for t in range(n):
        left, right = src(t)
        y = MOVER_Y0 + MOVER_VY_PX * t
        left[y:y + MOVER_PX, x:x + MOVER_PX] = obj
        right[y:y + MOVER_PX, x - D_FAR:x - D_FAR + MOVER_PX] = obj
        boxes, valid = np.zeros((nb, 4), np.float32), np.zeros(nb, bool)
        boxes[0] = [x - 5, y - 5, x + MOVER_PX + 5, y + MOVER_PX + 5]
        valid[0] = t % MOVER_MISS_EVERY != 0
        yield t, left, right, boxes, valid, t / cfg.camera.fps


def ground_truth(cfg, n: int) -> np.ndarray:
    """(n, 4, 4) T_wc of the scene's camera: identity rotation, x from
    ``io/synthetic.camera_x``."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import camera_x

    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = [camera_x(t, cfg.camera.bf, cfg.camera.fx) for t in range(n)]
    return gt


def pose_errors(poses: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """Max position (m) and rotation (rad) error of (n, 4, 4) T_wc against ``gt``."""
    pos = float(np.linalg.norm(poses[:, :3, 3] - gt[: len(poses), :3, 3], axis=1).max())
    return pos, max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(poses, gt))


def run_cli(label: str, args: list[str], out: str, expected: dict, n: int, gt: np.ndarray) -> dict:
    """``python -m stereo_semantic_vo_tpu_torch.run ARGS --out OUT`` in a
    subprocess with the default device: exit 0, the card's name as the
    report's device, the kernels' launches, n poses in the trajectory
    file within the ground-truth bounds.  -> its report."""
    from stereo_semantic_vo_tpu_torch.engine.trajectory import load_kitti_poses

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stereo_semantic_vo_tpu_torch.run", *args, "--out", out],
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S, cwd=REPO)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli {label}: exit code {proc.returncode}: {proc.stderr[-3000:]}")
    report = json.loads(proc.stdout[proc.stdout.index("{"):])
    check(report["device"] == torch.cuda.get_device_name(0), f"cli {label}: ran on {report['device']}")
    check(report["n_frames"] == n, f"cli {label}: {report['n_frames']} frames, expected {n}")
    check(report["kernel_launches"] == expected, f"cli {label}: kernel launches {report['kernel_launches']}, "
          f"expected {expected}")
    poses = load_kitti_poses(os.path.join(out, "cameratrajectory_kitti.txt"))
    pos, rot = pose_errors(poses, gt)
    check(len(poses) == n and pos <= POS_BOUND_M and rot <= ROT_BOUND_RAD,
          f"cli {label}: {len(poses)} poses, errors {pos} m / {rot} rad against ground truth")
    ate = report.get("ate_rmse_m")
    check(ate is None or ate <= ATE_BOUND_M, f"cli {label}: ATE {ate} m > {ATE_BOUND_M} m")
    say(f"cli {label}: exit 0 in {wall:.1f} s on {report['device']}; {n} poses, max errors {pos:.5f} m / {rot:.6f} "
        f"rad against ground truth, ATE {ate} m; median {report['median_s'] * 1e3:.2f} ms/frame; launches "
        f"{report['kernel_launches']}; culled per frame {report['n_culled_dynamic']}")
    return report


def in_process(cfg, dev, seq: str, boxes_dir: str | None, out: str, n: int):
    """The CLI's pipeline in this process: ``VOPipeline(cfg, device=dev)``
    on ``kitti.iter_frames`` of the same directory."""
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
    from stereo_semantic_vo_tpu_torch.io import kitti

    frame_iter = kitti.iter_frames(kitti.load_sequence_paths(seq), boxes_dir, cfg.semantic.max_boxes, n,
                                   image_hw=(cfg.camera.height, cfg.camera.width))
    pipe = VOPipeline(cfg, device=dev, out_dir=out)
    pipe.run(frame_iter)
    return pipe


def same_files(a: str, b: str) -> bool:
    names = ("cameratrajectory_kitti.txt", "cameratrajectory_tum.txt")
    return all(open(os.path.join(a, f), "rb").read() == open(os.path.join(b, f), "rb").read() for f in names)


def drive_cli(cfg, dev, card: str) -> dict:
    """The reference's shipped mode through ``run.py`` on the card, on a
    KITTI directory of the mover scene (``mover_frames``) with its box
    files and ground truth; then the same in this process.  -> each CLI
    run's launch counts."""
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, track_step
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
    from stereo_semantic_vo_tpu_torch.engine.trajectory import TrajectoryWriter
    from stereo_semantic_vo_tpu_torch.models import zoo

    n, n_s, win = N_CLI_FRAMES, N_CLI_SHORT_FRAMES, cfg.window.window_frames
    off_cfg = dataclasses.replace(cfg, use_semantics=False)
    gt = ground_truth(cfg, n)
    sparse = lambda k: {"extract_patches": k, "keypoint_stereo_costs": k, "fused_best_match": 2 * (k - 1),  # noqa: E731
                        "fast_scores": 0, "motion_hessian_gradient": 0, "sgm_aggregate": 0, "local_ba_blocks": 0,
                        "hamming_distance_matrix_pallas": 0, "cost_volumes": 0}
    dense = {**sparse(n_s), "keypoint_stereo_costs": 0, "sgm_aggregate": 4 * n_s, "cost_volumes": n_s,
             "local_ba_blocks": cfg.ba.local_iterations * (n_s - (win - 1))}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        seq, boxes_dir, gt_path = (os.path.join(tmp, d) for d in ("seq", "boxes", "gt.txt"))
        t0 = time.perf_counter()
        write_kitti_sequence(seq, mover_frames(cfg, n), cfg.camera.fps, boxes_dir)
        writer = TrajectoryWriter(gt_path)
        for t, T in enumerate(gt):
            writer.append(T, t / cfg.camera.fps)
        writer.close()
        say(f"cli: {n} mover frames written as a KITTI directory (8-bit PNGs, times.txt, "
            f"{len(os.listdir(boxes_dir))} box files, ground truth) in {time.perf_counter() - t0:.2f} s")
        common = ["--sequence", seq, "--seq-id", "00", "--gt", gt_path]
        out = {k: os.path.join(tmp, k) for k in ("offline", "no_semantics", "dense", "online", "in_offline",
                                                  "in_no_semantics")}
        rep = run_cli("offline boxes", [*common, "--boxes-dir", boxes_dir], out["offline"], sparse(n), n, gt)
        launches["cli_offline"] = rep["kernel_launches"]
        rep_off = run_cli("--no-semantics", [*common, "--boxes-dir", boxes_dir, "--no-semantics"],
                          out["no_semantics"], sparse(n), n, gt)
        launches["cli_no_semantics"] = rep_off["kernel_launches"]
        rep_d = run_cli("--dense-stereo --local-ba 1", [*common, "--boxes-dir", boxes_dir, "--dense-stereo",
                        "--local-ba", "1", "--max-frames", str(n_s)], out["dense"], dense, n_s, gt)
        launches["cli_dense_window_ba"] = rep_d["kernel_launches"]
        yolo_cfg = os.path.join(tmp, "kitti_tiny_v2.cfg")
        with open(yolo_cfg, "w") as f:
            f.write(zoo.KITTI_TINY_V2_CFG)
        rep_o = run_cli("--yolo-cfg", [*common, "--yolo-cfg", yolo_cfg, "--max-frames", str(n_s)], out["online"],
                        sparse(n_s), n_s, gt)
        launches["cli_online"] = rep_o["kernel_launches"]

        # the same directory in this process: the trajectory files byte for byte
        pipe = in_process(cfg, dev, seq, boxes_dir, out["in_offline"], n)
        pipe_off = in_process(off_cfg, dev, seq, boxes_dir, out["in_no_semantics"], n)
        for label, a, b in (("offline", "offline", "in_offline"), ("--no-semantics", "no_semantics", "in_no_semantics")):
            check(same_files(out[a], out[b]), f"cli {label}: the trajectory files differ from the in-process run's")
        culled = [int(o.n_culled_dynamic) for o in pipe.outputs]
        culled_off = [int(o.n_culled_dynamic) for o in pipe_off.outputs]
        check(culled == rep["n_culled_dynamic"] and culled_off == rep_off["n_culled_dynamic"],
              "cli: culled counts differ from the in-process runs'")
        after_miss = [c for t, c in enumerate(culled) if t % MOVER_MISS_EVERY == 1]
        check(sum(after_miss) > 0, f"offline: nothing culled in the frames after a missed box: {culled}")
        check(not any(culled_off), f"--no-semantics culled points: {culled_off}")
        for label, p in (("offline", pipe), ("--no-semantics", pipe_off)):
            pos, rot = pose_errors(np.stack([o.T_wc.cpu().numpy() for o in p.outputs]), gt)
            check(pos <= POS_BOUND_M and rot <= ROT_BOUND_RAD, f"in-process {label}: errors {pos} m / {rot} rad")
            say(f"in-process {label}: {n} frames of the PNGs, max errors {pos:.5f} m / {rot:.6f} rad against ground "
                f"truth; trajectory files byte for byte the CLI's")
        say(f"offline: culled per frame {culled} (missed box on frames t % {MOVER_MISS_EVERY} == 0; "
            f"{sum(after_miss)} culled in the frames after a miss); --no-semantics culled per frame {culled_off}")

        # the offline configuration on the host CPU: poses within the parity
        # tolerance; the culled counts are printed, not compared (the
        # fundamental fit's float32 rounding decides near-threshold verdicts)
        cpu = in_process(cfg, torch.device("cpu"), seq, boxes_dir, os.path.join(tmp, "cpu"), N_CLI_CPU_FRAMES)
        cpu_poses = np.stack([o.T_wc.numpy() for o in cpu.outputs])
        card_poses = np.stack([o.T_wc.cpu().numpy() for o in pipe.outputs[:N_CLI_CPU_FRAMES]])
        dpos = float(np.abs(cpu_poses[:, :3, 3] - card_poses[:, :3, 3]).max())
        drot = max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(cpu_poses, card_poses))
        check(dpos <= CPU_POS_TOL_M and drot <= CPU_ROT_TOL_RAD, f"offline: CPU vs card poses differ by {dpos} m / "
              f"{drot} rad")
        say(f"offline cpu rerun: {N_CLI_CPU_FRAMES} frames, max pose difference {dpos:.2e} m, {drot:.2e} rad; culled "
            f"per frame {[int(o.n_culled_dynamic) for o in cpu.outputs]} on the CPU, {culled[:N_CLI_CPU_FRAMES]} on "
            f"the card")

    # no sync in an offline-box step on the mover frame after a miss
    seq_frames = list(mover_frames(cfg, MOVER_MISS_EVERY + 2))
    first = VOPipeline(cfg, device=dev, write_trajectory=False)
    first.run(iter(seq_frames[:-1]), prefetch=False)
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in seq_frames[-1][1:5]))
    no_sync(f"one offline-box track_step on mover frame {MOVER_MISS_EVERY + 1}, after a miss",
            lambda: track_step(first.state, frame, cfg))
    say(f"cli phase on {card}")
    return launches


def same_run(a, b) -> bool:
    """Every output of every frame and the final ``VOState`` of two
    pipelines, bit for bit."""
    return (len(a.outputs) == len(b.outputs)
            and all(torch.equal(x, y) for oa, ob in zip(a.outputs, b.outputs) for x, y in zip(oa, ob))
            and all(torch.equal(x, y) for x, y in zip(a.state, b.state)))


def graph_stats(pipe) -> tuple[float, float, int]:
    """-> (capture ms, pool MiB, replays) of a pipeline's CUDA graphs."""
    graphs = [g for g in pipe.steps.graphs.values() if g.graph is not None]
    if pipe._det_graph is not None and pipe._det_graph.graph is not None:
        graphs.append(pipe._det_graph)
    return (sum(g.capture_ms for g in graphs), sum(g.pool_bytes for g in graphs) / 2**20,
            sum(g.replays for g in graphs))


def drive_graphs(paths, dev, kernels: dict, card: str) -> dict:
    """Phase 19: each path's frames eager and replaying CUDA graphs, in
    turns (eager, graph, eager, graph) in this process.  Each graph run
    equals each eager run bit for bit (every output of every frame, the
    final state) and launches each hand kernel as often; host ms/frame of
    each turn; capture ms, the graph pool, the device's idle share and
    kernels a frame of three profiled frames under each; no sync in a
    frame that replays.  -> the graph runs' launch counts by path."""
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline

    by_path = {}
    for label, cfg, n, every, det, steady_from in paths:
        turns = []
        for capture in (False, True, False, True):
            for k in kernels.values():
                k.launches = 0
            pipe = VOPipeline(cfg, device=dev, local_ba_every=every, detector=det, capture=capture,
                              write_trajectory=False)
            check(pipe.steps.capture == capture, f"graphs {label}: capture {pipe.steps.capture}")
            pipe.run(frames(cfg, n))
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in kernels.items()}
            steady = np.array(pipe.frame_times[steady_from:]) * 1e3
            turns.append((capture, pipe, launches, float(np.median(steady)), float(np.percentile(steady, 90))))
        eager = [t for t in turns if not t[0]]
        graph = [t for t in turns if t[0]]
        check(same_run(eager[0][1], eager[1][1]), f"graphs {label}: two eager runs differ")
        for g in graph:
            check(same_run(eager[0][1], g[1]), f"graphs {label}: a graph run differs from the eager run")
            check(g[2] == eager[0][2], f"graphs {label}: launches {g[2]} under graphs, {eager[0][2]} eager")
        cap_ms, pool_mib, replays = graph_stats(graph[-1][1])
        check(replays > 0, f"graphs {label}: nothing replayed")
        # three more frames of each kind under the profiler, then one
        # replaying frame with its deferred readback set aside
        extra = [(f[1], f[2], None, None, f[5]) if det is not None else f[1:] for f in list(frames(cfg, n + 4))[n:]]
        prof = {}
        for kind, t in (("eager", eager[-1]), ("graph", graph[-1])):
            pipe = t[1]
            busy, wall_p, n_k = device_busy(lambda: [pipe.process_frame(*f) for f in extra[:3]])
            prof[kind] = (busy / 3, wall_p / 3, n_k / 3)
        pipe = graph[-1][1]
        held = []
        finalize, pipe._finalize = pipe._finalize, lambda *item: held.append(item)
        no_sync(f"graphs {label}: one process_frame replaying the step's graphs", lambda: pipe.process_frame(*extra[3]))
        pipe._finalize = finalize
        for item in held:
            finalize(*item)
        launched = {k: v for k, v in graph[0][2].items() if v}
        say(f"graphs {label}: {n} frames, each graph run bit for bit the eager run (outputs of every frame, "
            f"final state) with the same launches ({launched}); host ms/frame median / p90 over frames "
            f"{steady_from}-{n - 1} in turns: " + ", ".join(
                f"{'graph' if c else 'eager'} {med:.3f} / {p90:.3f}" for c, _, _, med, p90 in turns))
        say(f"graphs {label}: capture {cap_ms:.1f} ms, graph pool {pool_mib:.1f} MiB, {replays} replays; three "
            f"profiled frames: eager device busy {prof['eager'][0]:.3f} of {prof['eager'][1]:.3f} ms a frame "
            f"(idle {100 * (1 - prof['eager'][0] / prof['eager'][1]):.1f}%, {prof['eager'][2]:.0f} kernels), graph "
            f"{prof['graph'][0]:.3f} of {prof['graph'][1]:.3f} ms (idle "
            f"{100 * (1 - prof['graph'][0] / prof['graph'][1]):.1f}%, {prof['graph'][2]:.0f} kernels); card {card}")
        by_path[f"graphs_{label}"] = {k: v + w for (k, v), w in zip(graph[0][2].items(), graph[1][2].values())}
        del turns, eager, graph, pipe
        torch.cuda.empty_cache()
    return by_path


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the port on a GPU")
    from stereo_semantic_vo_tpu_torch.core.config import VOConfig
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, track_step
    from stereo_semantic_vo_tpu_torch.engine.window_ba import refine_state
    from stereo_semantic_vo_tpu_torch.kernels import build, launch_counters

    card = card_line()
    print(card, flush=True)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    cfg = VOConfig.kitti("00")
    dense_cfg = dataclasses.replace(cfg, stereo=dataclasses.replace(cfg.stereo, sparse_mode="dense"))
    knob_cfg = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, fast_backend="pallas"),
                                   ba=dataclasses.replace(cfg.ba, hessian_backend="pallas"))

    # 1. build
    t0 = time.perf_counter()
    lib = build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> {lib.path}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"ptxas: {line.strip()}")

    # 2. each kernel against its plain version on the card
    rng = np.random.RandomState(0)
    popc_rate = popc_per_s()
    say(f"peak rates: {HBM_BYTES_PER_S / 1e12} TB/s, {FP32_FLOP_PER_S / 1e12} TFLOP/s float32, "
        f"{popc_rate / 1e12:.4f} T popcounts/s ({POPC_PER_CLOCK_PER_SM} a clock per SM at the top SM clock)")
    entries = [compare_patches(cfg, dev, rng), compare_stereo(cfg, dev, rng),
               compare_matcher(cfg, dev, rng, popc_rate), compare_fast(cfg, dev, rng), compare_motion_hessian(cfg, dev),
               compare_sgm(dense_cfg, dev), compare_local_ba(cfg, dev),
               compare_hamming_matrix(cfg, dev, rng, popc_rate), compare_cost_volumes(dense_cfg, dev)]

    # each entry's launch counter: extract_patches, fast_scores and
    # sgm_aggregate count on the batched entries they call
    kernels = launch_counters()
    off = {"fast_scores": 0, "motion_hessian_gradient": 0, "hamming_distance_matrix_pallas": 0, "cost_volumes": 0}
    by_path = {}

    # 3-5. the first path: sparse stereo, no window BA
    n_f = N_FRAMES
    expected = {"extract_patches": n_f, "keypoint_stereo_costs": n_f,
                "fused_best_match": 2 * (n_f - 1), "sgm_aggregate": 0, "local_ba_blocks": 0, **off}
    pipe, wall, slice_poses, by_path["sparse"] = drive_path("slice", cfg, dev, n_f, 0, kernels, expected)
    last = list(frames(cfg, n_f + 1))[-1]
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:5]))
    no_sync("one track_step", lambda: track_step(pipe.state, frame, cfg))
    cpu_rerun("slice", cfg, N_CPU_FRAMES, slice_poses)
    slice_steady = steady_state("slice", pipe, n_f, wall, card)

    # 6. the second path: dense stereo sampled at the keypoints, window BA every frame
    n_d, win = N_DENSE_FRAMES, cfg.window.window_frames
    expected = {"extract_patches": n_d, "keypoint_stereo_costs": 0,
                "fused_best_match": 2 * (n_d - 1), "sgm_aggregate": 4 * n_d,
                "local_ba_blocks": cfg.ba.local_iterations * (n_d - (win - 1)), **off, "cost_volumes": n_d}
    pipe, wall, poses, by_path["dense_window_ba"] = drive_path(
        "dense + window BA", dense_cfg, dev, n_d, 1, kernels, expected)
    last = list(frames(dense_cfg, n_d + 1))[-1]
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:5]))
    no_sync("one dense track_step", lambda: track_step(pipe.state, frame, dense_cfg))
    no_sync("one refine_state", lambda: refine_state(pipe.state, dense_cfg))
    cpu_rerun("dense + window BA", dense_cfg, N_DENSE_CPU_FRAMES, poses, local_ba_every=1)
    steady_state("dense + window BA", pipe, n_d, wall, card)

    # 7. the third path: the first path with the FAST kernel (one launch a
    # frame for every level, border mask and NMS fused) and the fused
    # motion-BA build at every LM step of the tracker's BA
    n_k = N_KNOB_FRAMES
    expected = {"extract_patches": n_k, "keypoint_stereo_costs": n_k,
                "fused_best_match": 2 * (n_k - 1), "sgm_aggregate": 0, "local_ba_blocks": 0,
                "fast_scores": n_k, "motion_hessian_gradient": cfg.ba.iterations * (n_k - 1),
                "hamming_distance_matrix_pallas": 0, "cost_volumes": 0}
    pipe, wall, poses, by_path["knobs"] = drive_path("knob path", knob_cfg, dev, n_k, 0, kernels, expected)
    n_both = min(n_k, N_FRAMES)
    dpos = np.abs(poses[:n_both, :3, 3] - slice_poses[:n_both, :3, 3]).max()
    drot = max(rotation_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(poses[:n_both], slice_poses))
    check(dpos <= PATH_POS_TOL_M and drot <= PATH_ROT_TOL_RAD,
          f"knob path vs first path: poses differ by {dpos} m / {drot} rad")
    say(f"knob path vs first path: {n_both} frames, max pose difference {dpos:.2e} m, {drot:.2e} rad")
    last = list(frames(knob_cfg, n_k + 1))[-1]
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:5]))
    no_sync("one knob-path track_step", lambda: track_step(pipe.state, frame, knob_cfg))
    cpu_rerun("knob path", knob_cfg, N_KNOB_CPU_FRAMES, poses)
    knob_steady = steady_state("knob path", pipe, n_k, wall, card)
    say("knob path beside the first path in this call: median / p90 {:.3f} / {:.3f} against {:.3f} / {:.3f} "
        "ms/frame".format(*knob_steady, *slice_steady))

    # 8-9. the online detector, then the fourth path: online detection one
    # frame late on a side stream, with the sparse path's kernel launches
    det = compare_detector(cfg, dev, card)
    n_o = N_ONLINE_FRAMES
    expected = {"extract_patches": n_o, "keypoint_stereo_costs": n_o,
                "fused_best_match": 2 * (n_o - 1), "sgm_aggregate": 0, "local_ba_blocks": 0, **off}
    by_path["online"] = drive_online(cfg, dev, det, kernels, expected, slice_steady, card)

    # 10. the fifth path: steered BRIEF, the sparse path's launch counts
    steer_cfg = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, steer=True))
    n_s = N_STEER_FRAMES
    expected = {"extract_patches": n_s, "keypoint_stereo_costs": n_s,
                "fused_best_match": 2 * (n_s - 1), "sgm_aggregate": 0, "local_ba_blocks": 0, **off}
    by_path["steered"] = drive_steered(steer_cfg, dev, kernels, expected, slice_steady, card)

    # 11. the whole-image stereo modes against strips and B2
    compare_volume_modes(cfg, dev)

    # 12. the data-parallel tracker at B = 1, 2, 4
    by_path["dp_tracker"] = drive_dp(cfg, dev, kernels, card)

    # 13. the landmark-sharded window BA over NCCL; its pipeline builds the
    # normal equations with the einsum build, as the reference's sharded body
    n_m = N_SHARDED_FRAMES
    expected = {"extract_patches": n_m, "keypoint_stereo_costs": n_m,
                "fused_best_match": 2 * (n_m - 1), "sgm_aggregate": 0, "local_ba_blocks": 0, **off}
    by_path["sharded_window_ba"] = drive_sharded(cfg, dev, kernels, expected, card)

    # 14. the replicated detector
    compare_replicated_detector(cfg, dev, det, card)

    # 15. detector training at full width: kitti_tiny_v2 (region loss), then tiny_v3 (yolo loss)
    from stereo_semantic_vo_tpu_torch.models import zoo

    tr = drive_trainer("kitti_tiny_v2", cfg, dev, zoo.KITTI_TINY_V2_CFG, N_TRAIN_STEPS, N_TRAIN_CPU_STEPS, card)
    compare_exported_detector(cfg, dev, tr, zoo.KITTI_TINY_V2_CFG)
    drive_trainer("tiny_v3", cfg, dev, zoo.TINY_V3_CFG, N_V3_STEPS, N_V3_CPU_STEPS, card)

    # 16. checkpoint and resume on the card, and a device trace
    resume_from_checkpoint(cfg, dev, slice_poses)

    # 17. the native frame loader
    native_loader_state(cfg)

    # 18. the reference's shipped mode through run.py on the card: offline
    # boxes over a moving object, --no-semantics, --dense-stereo --local-ba 1
    # and --yolo-cfg, each a subprocess counting its own launches
    by_path.update(drive_cli(cfg, dev, card))

    # 19. every path eager and under CUDA graphs, in turns
    by_path.update(drive_graphs([
        ("sparse", cfg, N_GRAPH_FRAMES, 0, None, 5), ("knob", knob_cfg, N_GRAPH_FRAMES, 0, None, 5),
        ("steered", steer_cfg, N_GRAPH_FRAMES, 0, None, 5),
        ("dense", dense_cfg, N_GRAPH_SHORT_FRAMES, 1, None, cfg.window.window_frames),
        ("online", cfg, N_GRAPH_SHORT_FRAMES, 0, det, 2)], dev, kernels, card))

    for e in entries:
        e["launches"] = sum(counts[e["name"]] for counts in by_path.values())
        e["launches_by_path"] = {path: counts[e["name"]] for path, counts in by_path.items()}
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
