"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. build the CUDA kernels of ``stereo_semantic_vo_tpu_torch/csrc`` with nvcc;
2. compare each kernel with its plain PyTorch version on the card, at the
   shapes the KITTI paths give it, and time both with CUDA events;
3. run ``VOPipeline(VOConfig.kitti("00"), device="cuda")`` on a procedural
   1241x376 two-plane sequence with exact ground truth, and check poses,
   tracking and that every kernel launched as often as the path calls it;
4. run the first frames again on the CPU (plain versions) and compare poses;
5. report the steady-state time per frame;
6. the same for the second path, dense stereo with window BA
   (``sparse_mode="dense"``, ``local_ba_every=1``, as
   ``run.py --dense-stereo --local-ba 1`` drives it): ground truth, exact
   launch counts, no host sync in a dense ``track_step`` or in
   ``refine_state``, a CPU rerun and the steady-state time per frame.

Prints the card (``nvidia-smi``), one JSON line with the kernels, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with an error before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 30        # GPU run of the slice
N_CPU_FRAMES = 8     # CPU rerun of the first frames
N_DENSE_FRAMES = 30  # GPU run of the dense + window-BA path
N_DENSE_CPU_FRAMES = 5  # its CPU rerun: frames 3 and 4 refine the window
POS_BOUND_M = 0.1    # per-frame camera position error against ground truth
ROT_BOUND_RAD = 0.01  # per-frame rotation error against ground truth (identity)
CPU_POS_TOL_M = 1e-3  # GPU vs CPU pose agreement (the slice parity tolerance)
CPU_ROT_TOL_RAD = 1e-3
STEREO_RTOL = 1e-5
BA_RTOL, BA_ATOL_REL, BA_COST_RTOL = 3e-5, 1e-4, 1e-5  # tests/test_ba_hessian.py's bounds


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
    from stereo_semantic_vo_tpu_torch.kernels.patch_extract import extract_patches, extract_patches_plain

    r = cfg.orb.patch_size // 2
    P = 2 * r + 1
    ms = plain_ms = 0.0
    for H, W, K in pyramid_shapes(cfg.orb, cfg.camera.height, cfg.camera.width):
        img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
        y0 = torch.from_numpy(rng.randint(0, H - P + 1, K).astype(np.int32)).to(dev)
        x0 = torch.from_numpy(rng.randint(0, W - P + 1, K).astype(np.int32)).to(dev)
        y0[:2], x0[:2] = torch.tensor([0, H - P]), torch.tensor([W - P, 0])  # corners
        got = extract_patches(img, y0, x0, r)
        want = extract_patches_plain(img, y0, x0, r)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"patches differ at level shape {H}x{W}, K={K}")
        ms += median_ms(lambda: extract_patches(img, y0, x0, r))
        plain_ms += median_ms(lambda: extract_patches_plain(img, y0, x0, r))
    say(f"patches: equal on all 8 level shapes; per frame {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    return {"name": "extract_patches", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/patch_extract.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/patch_extract.py:75",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def compare_stereo(cfg, dev, rng) -> dict:
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import (
        keypoint_stereo_costs,
        keypoint_stereo_costs_plain,
    )
    from stereo_semantic_vo_tpu_torch.ops.stereo import sparse_disparity
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source

    H, W, K = cfg.camera.height, cfg.camera.width, cfg.orb.max_keypoints
    sc = cfg.stereo
    left_np, right_np = two_plane_frame_source(H, W)(3)
    left, right = torch.from_numpy(left_np).to(dev), torch.from_numpy(right_np).to(dev)
    uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    uv[:4] = [[0, 0], [W - 1, H - 1], [3, 200], [W - 2, 5]]  # edge clamps
    uv_t = torch.from_numpy(uv).to(dev)
    D, r = sc.max_disparity, sc.block_radius
    P, Ws = 2 * r + 1, D + 2 * r
    x = torch.round(uv_t[:, 0]).to(torch.int32)
    y = torch.round(uv_t[:, 1]).to(torch.int32)
    y0 = torch.clamp(y - r, 0, H - P)
    xl0 = torch.clamp(x - r, 0, W - P)
    xr0 = torch.clamp(x - (D - 1) - r, 0, W - Ws)
    args = (left, right, y0, xl0, xr0, D, r, sc.color_weight, sc.grad_weight, sc.color_trunc, sc.grad_trunc)
    got = keypoint_stereo_costs(*args)
    want = keypoint_stereo_costs_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=STEREO_RTOL, atol=0.0), f"stereo costs differ (max abs {err})")
    cam = Camera.from_config(cfg.camera, dev)
    valid = torch.ones(K, dtype=torch.bool, device=dev)
    a = sparse_disparity(left, right, uv_t, valid, cam, dataclasses.replace(sc, sparse_mode="pallas"))
    b = sparse_disparity(left, right, uv_t, valid, cam, dataclasses.replace(sc, sparse_mode="strips"))
    check(torch.equal(a.valid, b.valid), "sparse_disparity valid masks differ")
    check(torch.allclose(a.disparity, b.disparity, rtol=0, atol=1e-4), "sparse_disparity disparities differ")
    ms = median_ms(lambda: keypoint_stereo_costs(*args))
    plain_ms = median_ms(lambda: keypoint_stereo_costs_plain(*args))
    say(f"stereo costs: max abs err {err} (rtol {STEREO_RTOL}), valid masks equal "
        f"({int(a.valid.sum())}/{K} valid); {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    return {"name": "keypoint_stereo_costs", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/sparse_stereo.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/sparse_stereo.py:142",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def compare_matcher(cfg, dev, rng) -> dict:
    from stereo_semantic_vo_tpu_torch.kernels.matcher import fused_best_match, fused_best_match_plain

    T = cfg.orb.max_keypoints
    ms = plain_ms = 0.0
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
        plain_ms += median_ms(lambda: fused_best_match_plain(*args))
    say(f"matcher: idx, best, second equal at Q=2048 and Q=512 against T={T}; "
        f"per track_step {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    return {"name": "fused_best_match", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/matcher.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/matcher.py:59",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def frame_aggregations(cfg, dev) -> list[tuple]:
    """The kernel arguments of the three SGM aggregations one dense frame
    makes (left and right volumes with their P2 planes, the refine volume at
    penalty scale 0.5), recorded from ``dense_disparity`` on a 1241x376 frame."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
    from stereo_semantic_vo_tpu_torch.ops import dense_stereo

    sc = cfg.stereo
    left, right = (torch.from_numpy(a).to(dev) for a in two_plane_frame_source(cfg.camera.height, cfg.camera.width)(3))
    calls, aggregate = [], dense_stereo.sgm_aggregate

    def record(vol, cfg, p2x_h=None, p2x_v=None, scale=1.0):
        calls.append((vol, sc.p1 * scale, sc.p2 * scale, p2x_h * scale, p2x_v * scale))
        return aggregate(vol, cfg, p2x_h, p2x_v, scale)

    dense_stereo.sgm_aggregate = record
    try:
        dense_stereo.dense_disparity(left, right, sc)
    finally:
        dense_stereo.sgm_aggregate = aggregate
    check(len(calls) == 3, f"a dense frame made {len(calls)} SGM aggregations, expected 3")
    return calls


def compare_sgm(cfg, dev) -> dict:
    """B6 on a frame's real cost volumes (376x1241x48): scalar P2, and the
    frame's three aggregations (P2 planes; the refine pass at scale 0.5)."""
    from stereo_semantic_vo_tpu_torch.kernels.sgm_scan import sgm_aggregate, sgm_aggregate_plain

    agg = frame_aggregations(cfg, dev)
    vol, p1, p2 = agg[0][:3]
    cases = [("scalar P2", (vol, p1, p2, None, None)), ("left, P2 planes", agg[0]),
             ("right, P2 planes", agg[1]), ("refine, scale 0.5", agg[2])]
    per_case = []
    for name, args in cases:
        got = sgm_aggregate(*args)
        want = sgm_aggregate_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"SGM kernel differs from its plain version ({name}): "
              f"max abs {float((got - want).abs().max())}")
        per_case.append(median_ms(lambda: sgm_aggregate(*args), reps=20, warmup=2))
    # a frame's three aggregations in one timed call, kernel and plain
    ms = median_ms(lambda: [sgm_aggregate(*args) for args in agg], reps=20, warmup=2)
    plain_ms = median_ms(lambda: [sgm_aggregate_plain(*args) for args in agg], reps=5, warmup=1)
    say("sgm: bit-equal to the plain version at 376x1241x48 (scalar P2, the frame's left and right "
        "aggregations with P2 planes, its refine at scale 0.5); per aggregation (4 launches) "
        + "; ".join(f"{n} {k:.3f} ms" for (n, _), k in zip(cases, per_case))
        + f"; per frame (3 aggregations) {ms:.3f} ms kernel, {plain_ms:.1f} ms plain")
    return {"name": "sgm_aggregate", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/sgm_scan.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/sgm_scan.py:117",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


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
    """B7 at the window's shape: F=4 poses, L=2048 landmarks, stereo row."""
    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.kernels.ba_hessian import local_ba_blocks, local_ba_blocks_plain

    cam = Camera.from_config(cfg.camera, dev)
    poses, X, obs, mask, ur, rm = local_ba_problem(cfg.camera, dev, cfg.window.window_frames, cfg.window.max_map_points)
    args = (poses, X, obs, mask, cam, cfg.ba.huber_delta, ur, rm)
    got = local_ba_blocks(*args)
    again = local_ba_blocks(*args)
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
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "local-BA kernel is not deterministic")
    ms = median_ms(lambda: local_ba_blocks(*args))
    plain_ms = median_ms(lambda: local_ba_blocks_plain(*args))
    say(f"local-BA blocks: F=4, L=2048 with the stereo row within rtol {BA_RTOL} / atol {BA_ATOL_REL} x max "
        f"(max abs err {err:.4g}), cost within rtol {BA_COST_RTOL}, two runs bit-equal; per build "
        f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    return {"name": "local_ba_blocks", "route": "cuda",
            "source": "stereo_semantic_vo_tpu_torch/csrc/ba_hessian.cu",
            "replaces": "stereo_semantic_vo_tpu/kernels/ba_hessian.py:270",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def run_slice(cfg, dev, n: int, local_ba_every: int = 0):
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline

    pipe = VOPipeline(cfg, device=dev, local_ba_every=local_ba_every)
    t0 = time.perf_counter()
    pipe.run(frames(cfg, n))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return pipe, time.perf_counter() - t0


def drive_path(label: str, cfg, dev, n_frames: int, local_ba_every: int, kernels: dict, expected: dict):
    """Run one path on the card with every launch count set to 0 just
    before; check the counts, tracking and ground truth.  -> (pipe, wall
    seconds, poses, launches)."""
    from stereo_semantic_vo_tpu_torch.io.synthetic import camera_x

    for k in kernels.values():
        k.launches = 0
    pipe, wall = run_slice(cfg, dev, n_frames, local_ba_every)
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches == expected, f"{label}: kernel launches {launches}, expected {expected}")
    poses = np.stack([o.T_wc.cpu().numpy() for o in pipe.outputs])
    check(len(poses) == n_frames and bool(np.isfinite(poses).all()), f"{label}: non-finite or missing poses")
    ok = [bool(o.pnp_ok) for o in pipe.outputs]
    check(all(ok[1:]), f"{label}: tracking lost at frames {[i for i, v in enumerate(ok) if not v]}")
    gt_x = np.array([camera_x(t, cfg.camera.bf, cfg.camera.fx) for t in range(n_frames)])
    pos_err = np.linalg.norm(poses[:, :3, 3] - np.stack([gt_x, 0 * gt_x, 0 * gt_x], -1), axis=1)
    rot_err = np.array([rotation_angle(T[:3, :3]) for T in poses])
    check(pos_err.max() <= POS_BOUND_M, f"{label}: position error {pos_err.max():.4f} m > {POS_BOUND_M} m")
    check(rot_err.max() <= ROT_BOUND_RAD, f"{label}: rotation error {rot_err.max():.5f} rad > {ROT_BOUND_RAD} rad")
    n = lambda f: [int(getattr(o, f)) for o in pipe.outputs]  # noqa: E731
    say(f"{label}: {n_frames} frames 1241x376 on the card, all tracked; max position error "
        f"{pos_err.max():.5f} m over {gt_x[-1]:.3f} m (bound {POS_BOUND_M}), max rotation error "
        f"{rot_err.max():.6f} rad; launches {launches}")
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


def steady_state(label: str, pipe, n_frames: int, wall: float, card: str) -> None:
    steady = np.array(pipe.frame_times[5:]) * 1000.0
    say(f"{label} steady state: median {np.median(steady):.3f} ms/frame, p90 "
        f"{np.percentile(steady, 90):.3f} ms (frames 5-{n_frames - 1}, host clock, one-frame-deferred "
        f"readback); whole run {wall:.2f} s incl. first-frame warm-up; card {card}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the port on a GPU")
    from stereo_semantic_vo_tpu_torch.core.config import VOConfig
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput, track_step
    from stereo_semantic_vo_tpu_torch.engine.window_ba import refine_state
    from stereo_semantic_vo_tpu_torch.kernels import build
    from stereo_semantic_vo_tpu_torch.kernels.ba_hessian import local_ba_blocks
    from stereo_semantic_vo_tpu_torch.kernels.matcher import fused_best_match
    from stereo_semantic_vo_tpu_torch.kernels.patch_extract import extract_patches
    from stereo_semantic_vo_tpu_torch.kernels.sgm_scan import sgm_aggregate
    from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import keypoint_stereo_costs

    card = card_line()
    print(card, flush=True)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    cfg = VOConfig.kitti("00")
    dense_cfg = dataclasses.replace(cfg, stereo=dataclasses.replace(cfg.stereo, sparse_mode="dense"))

    # 1. build
    t0 = time.perf_counter()
    lib = build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> {lib.path}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"ptxas: {line.strip()}")

    # 2. each kernel against its plain version on the card
    rng = np.random.RandomState(0)
    entries = [compare_patches(cfg, dev, rng), compare_stereo(cfg, dev, rng), compare_matcher(cfg, dev, rng),
               compare_sgm(dense_cfg, dev), compare_local_ba(cfg, dev)]

    kernels = {"extract_patches": extract_patches, "keypoint_stereo_costs": keypoint_stereo_costs,
               "fused_best_match": fused_best_match, "sgm_aggregate": sgm_aggregate,
               "local_ba_blocks": local_ba_blocks}
    by_path = {}

    # 3-5. the first path: sparse stereo, no window BA
    n_f = N_FRAMES
    expected = {"extract_patches": cfg.orb.n_levels * n_f, "keypoint_stereo_costs": n_f,
                "fused_best_match": 2 * (n_f - 1), "sgm_aggregate": 0, "local_ba_blocks": 0}
    pipe, wall, poses, by_path["sparse"] = drive_path("slice", cfg, dev, n_f, 0, kernels, expected)
    last = list(frames(cfg, n_f + 1))[-1]
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:5]))
    no_sync("one track_step", lambda: track_step(pipe.state, frame, cfg))
    cpu_rerun("slice", cfg, N_CPU_FRAMES, poses)
    steady_state("slice", pipe, n_f, wall, card)

    # 6. the second path: dense stereo sampled at the keypoints, window BA every frame
    n_d, win = N_DENSE_FRAMES, cfg.window.window_frames
    expected = {"extract_patches": cfg.orb.n_levels * n_d, "keypoint_stereo_costs": 0,
                "fused_best_match": 2 * (n_d - 1), "sgm_aggregate": 12 * n_d,
                "local_ba_blocks": cfg.ba.local_iterations * (n_d - (win - 1))}
    pipe, wall, poses, by_path["dense_window_ba"] = drive_path(
        "dense + window BA", dense_cfg, dev, n_d, 1, kernels, expected)
    last = list(frames(dense_cfg, n_d + 1))[-1]
    frame = FrameInput(*(torch.from_numpy(a).to(dev) for a in last[1:5]))
    no_sync("one dense track_step", lambda: track_step(pipe.state, frame, dense_cfg))
    no_sync("one refine_state", lambda: refine_state(pipe.state, dense_cfg))
    cpu_rerun("dense + window BA", dense_cfg, N_DENSE_CPU_FRAMES, poses, local_ba_every=1)
    steady_state("dense + window BA", pipe, n_d, wall, card)

    for e in entries:
        e["launches"] = sum(counts[e["name"]] for counts in by_path.values())
        e["launches_by_path"] = {path: counts[e["name"]] for path, counts in by_path.items()}
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
