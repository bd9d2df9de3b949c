"""The least time the card could take for each hand-written kernel's work
in one frame, from the cell's shapes: the bytes it must move once at the
HBM rate, or its operations at their peak rate, whichever is larger.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor
cores; popcounts at 16 a clock per SM at the card's top SM clock.

Where the bytes depend on the data (the image pixels under the union of
the patches, windows and strips around the keypoints), the count is the
expected union of windows placed uniformly at random, which the
keypoints' grid selection spreads further apart than random: so the
bytes, and the bound, are if anything too low and the share of the
roofline too low, never too high.

The kernels, by the fragments of their CUDA names:
B1 patches (``extract_patches``), B2 the per-keypoint stereo step
(``keypoint_stereo``), B3 the fused matcher (``fused_best_match``), the
dense cost volumes (``dense_cost_volumes``: both volumes of a frame in one
launch), B6 SGM (``sgm_``: its sweeps and sum), B7 the local-BA block build
(``local_ba_blocks``).

``detector_flops`` counts a darknet cfg's model FLOPs a frame, the
numerator of ``detector.mfu``.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
POPC_PER_CLOCK_PER_SM = 16
H100_SMS, H100_MAX_SM_MHZ = 132, 1980.0  # the SXM part's 132 SMs at 1,980 MHz

FRAGMENTS = {
    "patches": ("extract_patches",),
    "keypoint_stereo": ("keypoint_stereo",),
    "matcher": ("fused_best_match",),
    "cost_volumes": ("dense_cost_volumes",),
    "sgm": ("sgm_",),
    "local_ba_blocks": ("local_ba_blocks",),
}


def popc_per_s(sms: int = H100_SMS, max_sm_mhz: float = H100_MAX_SM_MHZ) -> float:
    return POPC_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6


def bound_s(nbytes: float, ops: float, op_rate: float = FP32_FLOP_PER_S) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / op_rate)


def expected_covered(H: int, W: int, h: int, w: int, n: int) -> float:
    """Expected pixels of an (H, W) image under the union of ``n`` h x w
    windows placed uniformly at random."""
    return H * W * (1.0 - (1.0 - min(1.0, h * w / (H * W))) ** n)


def pyramid(orb: dict, H: int, W: int) -> list[tuple[int, int, int]]:
    """(H_l, W_l, K_l) of each ORB level: its image and its candidates."""
    n = 2 * orb["max_keypoints"]
    inv = [1.0 / orb["scale_factor"] ** l for l in range(orb["n_levels"])]
    budgets = [max(8, int(round(n * w / sum(inv)))) for w in inv]
    cells = orb["grid_rows"] * orb["grid_cols"]
    out = []
    for level in range(orb["n_levels"]):
        out.append((H, W, cells * max(1, math.ceil(budgets[level] / cells))))
        H = max(int(round(H / orb["scale_factor"])), 32)
        W = max(int(round(W / orb["scale_factor"])), 32)
    return out


def patches_s(orb: dict, H: int, W: int) -> float:
    """B1, a frame: every level's P x P patches in one launch; the pixels
    under the patches read once, every patch pixel written, the origins."""
    r = orb["half_patch"] if orb["steer"] else orb["patch_size"] // 2
    P = 2 * r + 1
    nbytes = sum(expected_covered(h, w, P, P, k) * 4 + k * P * P * 4 + k * 8 for h, w, k in pyramid(orb, H, W))
    return bound_s(nbytes, 0.0)


def keypoint_stereo_s(stereo: dict, K: int, H: int, W: int) -> float:
    """B2, a frame: the fused per-keypoint step; the left windows and right
    strips with a gradient column either side read once, 10 flops a window
    term; uv, validity and bf in, disparity, depth, cost and valid out."""
    D, r = stereo["max_disparity"], stereo["block_radius"]
    P, Ws = 2 * r + 1, D + 2 * r
    covered = expected_covered(H, W, P, P + 2, K) + expected_covered(H, W, P, Ws + 2, K)
    return bound_s(4 * covered + 9 * K + 4 + 13 * K, 10.0 * K * D * P * P)


def matcher_s(K: int, M: int, popc_rate: float) -> float:
    """B3, a tracked frame: the last frame's K and the map's M descriptors
    against the frame's K; 8 popcounts a pair; words and masks in, three
    ints a query out."""
    return sum(bound_s((Q + K) * 33 + 12 * Q, Q * K * 8.0, popc_rate) for Q in (K, M))


def cost_volumes_s(stereo: dict, H: int, W: int) -> float:
    """The dense cost volumes, a frame: the left and right images read once,
    the left- and right-based (H, W, D) volumes written; the 49-term box
    sums' adds run far under the float32 peak, so bytes bound it."""
    return bound_s(2 * H * W * 4 + 2 * H * W * stereo["max_disparity"] * 4, 0.0)


def sgm_s(stereo: dict, H: int, W: int) -> float:
    """B6, a dense frame: the left and right volumes and, with the refine
    pass, a third; each volume in and its sum out, the P2 planes in; ~8
    flops a cell and direction, 4 directions."""
    V = H * W * stereo["max_disparity"]
    n = 3 if stereo["refine"] else 2
    planes = 2 * H * W * 4 if stereo["edge_p2"] else 0
    return bound_s(n * (2 * V * 4 + planes), n * 32.0 * V)


def local_ba_blocks_s(F: int, L: int, builds: int) -> float:
    """B7, a refine: ``builds`` block builds of F poses and L landmarks
    with the stereo row; poses, points, observations, u_R, intrinsics and
    the two masks in; Hcc, Hcp, Hpp, gc, gp and the cost out; ~600 flops a
    (frame, landmark)."""
    nbytes = 4 * (16 * F + 3 * L + 3 * F * L + 5) + 2 * F * L + 4 * (36 * F + 18 * F * L + 9 * L + 6 * F + 3 * L + 1)
    return builds * bound_s(nbytes, 600.0 * F * L)


def frame_bounds(vo: dict, local_ba_every: int, popc_rate: float) -> dict[str, float]:
    """-> {kernel: bound seconds a tracked frame} for the kernels a card
    runs on this configuration's path (the "auto" and "pallas" knobs)."""
    cam, orb, st = vo["camera"], vo["orb"], vo["stereo"]
    H, W, K = cam["height"], cam["width"], orb["max_keypoints"]
    M = vo["window"]["window_frames"] * K
    kernel = ("auto", "pallas")
    out = {}
    if orb["patch_backend"] in kernel:
        out["patches"] = patches_s(orb, H, W)
    if st["sparse_mode"] in kernel:
        out["keypoint_stereo"] = keypoint_stereo_s(st, K, H, W)
    if vo["matcher"]["backend"] in kernel:
        out["matcher"] = matcher_s(K, M, popc_rate)
    if st["sparse_mode"] == "dense" and st["dense_backend"] in kernel:
        out["cost_volumes"] = cost_volumes_s(st, H, W)
        out["sgm"] = sgm_s(st, H, W)
    if local_ba_every > 0 and vo["ba"]["local_hessian_backend"] in kernel:
        out["local_ba_blocks"] = local_ba_blocks_s(vo["window"]["window_frames"], M,
                                                   vo["ba"]["local_iterations"]) / local_ba_every
    return out


def detector_flops(cfg_text: str) -> float:
    """2 x the multiply-adds of every convolution of a darknet cfg at its
    input size (darknet's ``BFLOPs``): 3.82 G for tiny YOLOv2 at 352."""
    from vo_bench.reference import detector

    shapes, convs = detector.walk(detector.parse_cfg(cfg_text))
    return float(sum(2 * cv.n * cv.c * cv.size * cv.size * shapes[cv.index].h * shapes[cv.index].w
                     for cv in convs))
