"""PyTorch port on a CUDA card: each hand kernel against its plain version
at the main path's shapes, and the tracking step without host syncs.

Every test here needs a card and skips without one.  The file imports no
JAX, so it also runs on a machine that has only PyTorch, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: patches (all pyramid levels in one launch) and matcher outputs exact; stereo costs
and the fused stereo step's disparity, depth, valid and cost exact (the
kernel sums in the plain version's order and rounds each operation as
PyTorch does); SGM aggregation
exact (min, add and subtract in the plain version's order); both dense
cost volumes of one launch exact against ``cost_volume`` on the card (each
operation rounded as PyTorch's CUDA ops round it, the window summed in the
plain order, the normalisation PyTorch's multiply by the float32
reciprocal), and ``dense_disparity`` and five frames of the dense
pipeline through the kernel exact against the plain loops; the local-BA
blocks rtol 3e-5, atol 1e-4 x max|plain|, cost rtol 1e-5, and the
motion-only build rtol 2e-5, atol 1e-6 x max|plain|, cost rtol 1e-5
(tests/test_ba_hessian.py's bounds: float32 sums in another order); FAST
scores and the Hamming matrix exact; the online detector on the card
against the CPU (cuDNN against the CPU's convolutions, TF32 off): head maps
rtol 1e-4, atol 1e-4 x max|CPU|, boxes 1e-2 px where valid, valid equal;
steered ORB on the card against the CPU: keypoints exact, at most 0.5% of
the descriptor bits differ (the moments' sums run in another order); the
volume stereo modes on the card against the CPU and against B2 where the
strip is not clamped: valid equal, disparity 1e-4 px; the data-parallel
tracker's streams equal, bit for bit, their single-stream runs, and its
graph runs (a graph pair, a pool and a capture stream a stream) its eager
runs, a replaying step without a sync; the sharded
BA at one rank over NCCL equal to ``local_ba`` with the same einsum build,
and within tests/test_sharded_ba.py's bounds of the B7 build; two ranks
over NCCL (two cards) within the worker's bounds; three train steps on the
card against the CPU: loss rtol 1e-4, every param, statistic and momentum
buffer atol 1e-3 x max|CPU| (cuDNN's forward and backward convolutions sum
in another order); the trainer's step replayed as a CUDA graph equal, bit
for bit, to eager runs under cuDNN's deterministic algorithms, a replayed
step without a sync; a detector from the exported weights equal to one from
the folded params; a pipeline resumed from a checkpoint equal, bit for bit,
to the uninterrupted run; on chip_smoke.py's mover scene, a step of
``run.py --no-semantics``'s configuration on the card against the CPU
within 1e-3 m and 1e-3 rad, and nothing culled without semantics; the
pipeline replaying CUDA graphs of its step equal, bit for bit, to its eager
dispatch (sparse and knob over 8 frames, dense with a refine every frame
over 5), capturing and replaying without a sync, and raising where a
captured function reads back; ``process_frame(t)`` returning long before a
200 ms sleep queued after frame t's replay ends, the run unchanged; on an
in-process one-rank NCCL group, the sharded runner's graph and the mesh
pipeline's (its refine graph holding the collectives, 8 frames, a refine a
frame) equal, bit for bit, to their eager runs; the replicated detector's
graph at 2 and 4 frames equal, bit for bit, to its eager batched program;
a replay of each of these graphs without a sync; the tracer's stage
stamps inside the step graphs rising through every replay under sync
debug mode, tiling each call, every slot written, and the state bit for
bit that of graphs captured with the tracer off."""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu_torch.core.camera import Camera
from stereo_semantic_vo_tpu_torch.core.config import CameraConfig, StereoConfig, VOConfig
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import init_state
from stereo_semantic_vo_tpu_torch.io.synthetic import two_plane_frame_source
from stereo_semantic_vo_tpu_torch.engine.window_ba import refine_state
from stereo_semantic_vo_tpu_torch.kernels import ba_hessian as TB
from stereo_semantic_vo_tpu_torch.kernels import cost_volume as TCV
from stereo_semantic_vo_tpu_torch.kernels import fast_score as TF
from stereo_semantic_vo_tpu_torch.kernels import hamming as TH
from stereo_semantic_vo_tpu_torch.kernels import matcher as TM
from stereo_semantic_vo_tpu_torch.kernels import patch_extract as TP
from stereo_semantic_vo_tpu_torch.kernels import sgm_scan as TG
from stereo_semantic_vo_tpu_torch.ops.dense_stereo import cost_volume, dense_disparity, edge_p2_planes
from stereo_semantic_vo_tpu_torch.ops.orb import extract_orb, pyramid
from stereo_semantic_vo_tpu_torch.kernels import sparse_stereo as TS
from stereo_semantic_vo_tpu_torch.models import zoo
from stereo_semantic_vo_tpu_torch.ops.stereo import sparse_disparity

# self-contained (no `tests.` imports): where a site package is named
# `tests`, it shadows this directory once conftest.py is not loaded
pytestmark = pytest.mark.cuda
H, W = 376, 1241


def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no interpret mode)")
    return torch.device("cuda", 0)


def t(a, device) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)


def random_desc(rng, count):
    return rng.randint(0, 2**32, (count, 8), dtype=np.uint64).astype(np.uint32)


def _launched(fn, counter, *args):
    """Call a kernel wrapper; check it launched exactly once."""
    before = counter.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    return out


@pytest.mark.parametrize("shape,K", [((376, 1241), 256), ((182, 598), 128), ((106, 346), 128)])
def test_patch_kernel_matches_plain(shape, K):
    dev = cuda_device()
    rng = np.random.RandomState(0)
    h, w = shape
    img = rng.uniform(0, 255, shape).astype(np.float32)
    y0 = rng.randint(0, h - 31 + 1, K).astype(np.int32)
    x0 = rng.randint(0, w - 31 + 1, K).astype(np.int32)
    y0[:2], x0[:2] = [0, h - 31], [w - 31, 0]
    args = (t(img, dev), t(y0, dev), t(x0, dev), 15)
    got = _launched(TP.extract_patches, TP.extract_patches_levels, *args)
    assert torch.equal(got, TP.extract_patches_plain(*args))


def test_patch_levels_kernel_matches_plain_at_the_level_shapes():
    """One launch for the 8 KITTI levels (376x1241 ... 106x346, K 256 / 128),
    corner origins included."""
    dev = cuda_device()
    rng = np.random.RandomState(1)
    levels = pyramid(t(rng.uniform(0, 255, (H, W)).astype(np.float32), dev), VOConfig.kitti().orb)
    assert [tuple(x.shape) for x in levels[::7]] == [(376, 1241), (106, 346)]
    ys, xs, counts = [], [], []
    for img in levels:
        h, w = img.shape
        K = 256 if h > 200 else 128
        y0 = rng.randint(0, h - 31 + 1, K).astype(np.int32)
        x0 = rng.randint(0, w - 31 + 1, K).astype(np.int32)
        y0[:2], x0[:2] = [0, h - 31], [w - 31, 0]
        ys.append(y0)
        xs.append(x0)
        counts.append(K)
    args = (levels, t(np.concatenate(ys), dev), t(np.concatenate(xs), dev), counts, 15)
    got = _launched(TP.extract_patches_levels, TP.extract_patches_levels, *args)
    assert got.shape == (sum(counts), 31, 31) and sum(counts) == 1536
    assert torch.equal(got, TP.extract_patches_levels_plain(*args))


def test_stereo_kernel_matches_plain():
    """The raw costs (the TPU kernel's contract, the epilogue off) and the
    fused step behind sparse_disparity, bit-equal to their plain versions."""
    dev = cuda_device()
    left, right = (t(a, dev) for a in two_plane_frame_source(H, W)(2))
    rng = np.random.RandomState(1)
    K, D, r = 512, 48, 3
    y0 = t(rng.randint(0, H - 7 + 1, K).astype(np.int32), dev)
    xl0 = t(np.r_[0, W - 7, rng.randint(0, W - 7 + 1, K - 2)].astype(np.int32), dev)
    xr0 = t(np.r_[0, W - D - 6, rng.randint(0, W - D - 6 + 1, K - 2)].astype(np.int32), dev)
    args = (left, right, y0, xl0, xr0, D, r, 0.11, 0.89, 7.0, 2.0)
    got = _launched(TS.keypoint_stereo_costs, TS.keypoint_stereo_costs, *args)
    assert torch.equal(got, TS.keypoint_stereo_costs_plain(*args))
    uv = t(np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32), dev)
    valid = torch.ones(K, dtype=torch.bool, device=dev)
    cam = Camera.from_config(CameraConfig(), dev)
    a = _launched(sparse_disparity, TS.keypoint_stereo_costs, left, right, uv, valid, cam,
                  StereoConfig(sparse_mode="pallas"))
    b = sparse_disparity(left, right, uv, valid, cam, StereoConfig(sparse_mode="strips"))
    assert int(a.valid.sum()) > K // 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def stereo_step_inputs(dev, K=512, D=48, r=3, seed=4):
    """The smoke scene with a constant patch (every window cost ties), K
    keypoints: the four corners, x < D + r (strip clamped at the left edge,
    shift > 0), half-pixel coordinates (round half to even), in the patch,
    ~10% not valid."""
    left, right = two_plane_frame_source(H, W)(2)
    left, right = left.copy(), right.copy()
    left[100:140, 600:700] = 128.0
    right[100:140, 500:700] = 128.0
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    uv[:12] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0], [3, 200], [D + r - 2, 50], [20.5, 80.5],
               [60.5, 20.5], [61.5, 21.5], [650, 120], [660.5, 110], [690, 130]]
    valid = rng.rand(K) > 0.1
    valid[:12] = True
    valid[12:16] = False
    return [t(a, dev) for a in (left, right, uv, valid)]


@pytest.mark.parametrize("D,r", [(48, 3), (64, 2)])
def test_stereo_step_kernel_matches_plain(D, r):
    """keypoint_disparity (one launch, the epilogue fused) against its plain
    version: disparity, depth, valid and cost bit-equal, at kitti()'s
    compile-time shape and at a runtime shape (r=2, D=64); the raw costs
    of the runtime shape too."""
    dev = cuda_device()
    left, right, uv, valid = stereo_step_inputs(dev, D=D, r=r)
    sc = StereoConfig()
    bf = Camera.from_config(CameraConfig(), dev).bf
    args = (left, right, uv, valid, bf, D, r, sc.color_weight, sc.grad_weight, sc.color_trunc, sc.grad_trunc,
            sc.uniqueness_ratio, sc.min_disparity)
    got = _launched(TS.keypoint_disparity, TS.keypoint_stereo_costs, *args)
    want = TS.keypoint_disparity_plain(*args)
    for name, x, y in zip(("disparity", "depth", "valid", "cost"), got, want):
        assert torch.equal(x, y), name
    ok = got[2].cpu().numpy()
    assert ok.sum() > 200 and not ok[12:16].any() and not ok[9:12].any()  # invalid ones; the patch ties
    y0, xl0, xr0, shift = TS.keypoint_origins(uv, H, W, D, r)
    assert int(shift[4]) > 0 and int(shift[5]) > 0
    raw = (left, right, y0, xl0, xr0, D, r, sc.color_weight, sc.grad_weight, sc.color_trunc, sc.grad_trunc)
    assert torch.equal(_launched(TS.keypoint_stereo_costs, TS.keypoint_stereo_costs, *raw),
                       TS.keypoint_stereo_costs_plain(*raw))


def test_stereo_step_is_one_launch_two_allocations_and_capturable():
    """The step puts one kernel on the device and nothing else, allocates
    its two outputs and no more, and replays from a CUDA graph."""
    dev = cuda_device()
    left, right, uv, valid = stereo_step_inputs(dev)
    sc = StereoConfig()
    bf = Camera.from_config(CameraConfig(), dev).bf
    args = (left, right, uv, valid, bf, 48, 3, sc.color_weight, sc.grad_weight, sc.color_trunc, sc.grad_trunc,
            sc.uniqueness_ratio, sc.min_disparity)
    names = _device_events(lambda: TS.keypoint_disparity(*args))
    assert len(names) == 1 and "keypoint_stereo_kernel" in names[0], names
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    eager = TS.keypoint_disparity(*args)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 2
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TS.keypoint_disparity(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = TS.keypoint_disparity(*args)
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(captured, eager):
        assert torch.equal(x, y)


def test_stereo_wrappers_refuse_what_the_kernel_cannot_take():
    dev = cuda_device()
    left, right, uv, valid = stereo_step_inputs(dev, K=16)
    bf = Camera.from_config(CameraConfig(), dev).bf
    rest = (0.11, 0.89, 7.0, 2.0, 0.95, 0.5)
    with pytest.raises(ValueError, match="D=300"):
        TS.keypoint_disparity(left, right, uv, valid, bf, 300, 3, *rest)
    with pytest.raises(ValueError, match="uv"):
        TS.keypoint_disparity(left, right, uv.double(), valid, bf, 48, 3, *rest)
    with pytest.raises(ValueError, match="kp_valid"):
        TS.keypoint_disparity(left, right, uv, valid.cpu(), bf, 48, 3, *rest)
    with pytest.raises(ValueError, match="wider than the image"):
        TS.keypoint_disparity(left[:, :40].contiguous(), right[:, :40].contiguous(), uv, valid, bf, 48, 3, *rest)


@pytest.mark.parametrize("Q", [1, 512, 2048, 2049])
@pytest.mark.parametrize("case", ["random", "all_invalid", "duplicates"])
def test_matcher_kernel_matches_plain(Q, case):
    dev = cuda_device()
    rng = np.random.RandomState(Q)
    T = 512
    q, tr = random_desc(rng, Q), random_desc(rng, T)
    qv, tv = rng.rand(Q) > 0.2, rng.rand(T) > 0.2
    if case == "all_invalid":
        qv[:] = False
    elif case == "duplicates":
        tr[9] = tr[4]
        q[:8] = tr[100 : 100 + min(Q, 8)]
        q[min(Q, 21) - 1] = tr[4]
        tv[:] = True
    args = [t(a, dev) for a in (q, tr, qv, tv)]
    got = _launched(TM.fused_best_match, TM.fused_best_match, *args)
    for g, w in zip(got, TM.fused_best_match_plain(*args)):
        assert torch.equal(g, w)
    if case == "duplicates":
        assert int(got[0][min(Q, 21) - 1]) == 4 and int(got[1][min(Q, 21) - 1]) == 0


@pytest.mark.parametrize("T", [1, 31, 33, 512, 517])
@pytest.mark.parametrize("case", ["random", "ties", "all_masked"])
def test_matcher_kernel_slice_edge_cases(T, case):
    """tests/test_torch_matcher.py's cases for the lanes' strided slices:
    ties across slices (rows 1 and 2) and within one (rows T-33 and T-1),
    every pair masked, T around the warp width; Q=1 and Q=2049, bit-equal
    to the plain version."""
    dev = cuda_device()
    rng = np.random.RandomState(T)
    for Q in (1, 2049):
        q, tr = random_desc(rng, Q), random_desc(rng, T)
        qv, tv = rng.rand(Q) > 0.2, rng.rand(T) > 0.2
        if case == "ties" and T >= 3:
            tr[2] = tr[1]
            q[0], qv[0], tv[1:3] = tr[1], True, True
            if T > 32 and Q > 1:
                tr[T - 1] = tr[T - 33]
                q[1], qv[1], tv[T - 33], tv[T - 1] = tr[T - 1], True, True, True
        elif case == "all_masked":
            tv[:] = False
        args = [t(a, dev) for a in (q, tr, qv, tv)]
        got = _launched(TM.fused_best_match, TM.fused_best_match, *args)
        for g, w in zip(got, TM.fused_best_match_plain(*args)):
            assert torch.equal(g, w), Q
        if case == "ties" and T >= 3:
            assert int(got[0][0]) == 1 and int(got[1][0]) == 0
            if T > 32 and Q > 1:
                assert int(got[0][1]) == T - 33 and int(got[1][1]) == 0 and int(got[2][1]) == 0
        if case == "all_masked":
            assert (got[0] == 0).all() and (got[1] == 257).all() and (got[2] == 257).all()


@pytest.mark.parametrize(
    "shape,case",
    [((376, 1241, 48), "scalar"), ((376, 1241, 48), "planes"), ((376, 1241, 48), "half"),
     ((13, 67, 33), "planes"), ((20, 40, 17), "planes"), ((9, 5, 64), "scalar")],
)
def test_sgm_kernel_matches_plain(shape, case):
    """Bit-equal at the path's shape, and at D above and below one warp."""
    dev = cuda_device()
    H, W, D = shape
    rng = np.random.RandomState(H + W + D)
    if shape == (376, 1241, 48):
        left, right = (t(a, dev) for a in two_plane_frame_source(H, W)(1))
        sc = StereoConfig(edge_p2=True, edge_p2_gamma=5.0)
        vol = cost_volume(left, right, sc)
        ph, pv = edge_p2_planes(left, sc)
    else:
        vol = t(rng.uniform(0, 3, shape).astype(np.float32), dev)
        ph, pv = (t(rng.uniform(1, 8, (H, W)).astype(np.float32), dev) for _ in range(2))
    scale = 0.5 if case == "half" else 1.0
    planes = (None, None) if case == "scalar" else (ph * scale, pv * scale)
    args = (vol, 1.0 * scale, 8.0 * scale, *planes)
    before = TG.sgm_aggregate_batch.launches  # sgm_aggregate counts there
    got = TG.sgm_aggregate(*args)
    torch.cuda.synchronize()
    assert TG.sgm_aggregate_batch.launches == before + 2
    assert torch.equal(got, TG.sgm_aggregate_plain(*args))


@pytest.mark.parametrize("D", [1, 33, 48, 64])
def test_sgm_batch_kernel_matches_plain(D):
    """Two volumes in the same two launches, one with P2 planes and one
    without, bit-equal to one plain aggregation each."""
    dev = cuda_device()
    rng = np.random.RandomState(D)
    shape = (23, 71, D)
    vols = [t(rng.uniform(0, 3, shape).astype(np.float32), dev) for _ in range(2)]
    ph, pv = (t(rng.uniform(1, 8, shape[:2]).astype(np.float32), dev) for _ in range(2))
    before = TG.sgm_aggregate_batch.launches
    got = TG.sgm_aggregate_batch(vols, 1.0, 8.0, [ph, None], [pv, None])
    torch.cuda.synchronize()
    assert TG.sgm_aggregate_batch.launches == before + 2
    assert torch.equal(got[0], TG.sgm_aggregate_plain(vols[0], 1.0, 8.0, ph, pv))
    assert torch.equal(got[1], TG.sgm_aggregate_plain(vols[1], 1.0, 8.0))


def test_sgm_kernel_min_key_on_signed_zeros_negatives_and_large_costs():
    """prev_min is a min over uint32 keys of the floats: -0.0 against 0.0,
    negative costs and costs near 1e20 keep their order."""
    dev = cuda_device()
    rng = np.random.RandomState(5)
    vol = rng.choice(np.array([-0.0, 0.0, 1.0, -3.5, 2.5e19, 1e20], np.float32), (17, 39, 48))
    vol[:, :, :5] = -0.0
    args = (t(vol, dev), 1.0, 8.0, None, t(rng.uniform(0, 8, (17, 39)).astype(np.float32), dev))
    got = TG.sgm_aggregate(*args)
    want = TG.sgm_aggregate_plain(*args)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "shape,D,r,kind",
    [((376, 1241), 48, 3, "frame"), ((376, 1241), 48, 3, "random"), ((376, 1241), 48, 3, "constant"),
     ((21, 40), 48, 3, "random"), ((5, 90), 48, 3, "random"), ((3, 47), 48, 3, "constant"),
     ((31, 77), 33, 3, "random"), ((23, 100), 64, 3, "random"), ((29, 83), 20, 2, "random"),
     ((17, 60), 7, 1, "random")],
)
def test_cost_volume_kernel_matches_plain(shape, D, r, kind):
    """Both volumes of one launch bit-equal to ``cost_volume`` of each base
    on the card: at the path's shape, W <= D (the shifts wrap more than
    once), H < 7 (every window meets the zero pad), D off a multiple of 4
    or 32, other radii; on a pair of constant images every raw cost is the
    same, so the zero pad shows as smaller sums at the corners."""
    dev = cuda_device()
    H, W = shape
    sc = StereoConfig(max_disparity=D, block_radius=r)
    if kind == "frame":
        left, right = (t(a, dev) for a in two_plane_frame_source(H, W)(1))
    elif kind == "constant":
        left, right = torch.full(shape, 37.0, device=dev), torch.full(shape, 40.0, device=dev)
    else:
        rng = np.random.RandomState(H * W + D + r)
        left, right = (t(rng.uniform(0, 255, shape).astype(np.float32), dev) for _ in range(2))
    got = _launched(TCV.cost_volumes, TCV.cost_volumes, left, right, sc)
    for right_base, g in zip((False, True), got):
        want = cost_volume(left, right, sc, right_base)
        assert g.shape == (H, W, D) and g.is_contiguous()
        assert torch.equal(g, want), (right_base, float((g - want).abs().max()))
    if kind == "constant":
        assert 0.0 < float(got[0][0, 0, 0]) < float(got[0].max())


@pytest.mark.parametrize("refine", [True, False])
def test_dense_disparity_kernel_equals_plain_loop(refine):
    """``dense_disparity`` on a 1241x376 frame: "auto" on the card (one
    cost-volume launch) equals "xla" (the plain loop, no launch) bit for
    bit, disparity, valid and measured."""
    dev = cuda_device()
    left, right = (t(a, dev) for a in two_plane_frame_source(H, W)(2))
    sc = StereoConfig(edge_p2=True, edge_p2_gamma=5.0, refine=refine)
    before = TCV.cost_volumes.launches
    got = dense_disparity(left, right, sc)
    torch.cuda.synchronize()
    assert TCV.cost_volumes.launches == before + 1
    want = dense_disparity(left, right, dataclasses.replace(sc, dense_backend="xla"))
    torch.cuda.synchronize()
    assert TCV.cost_volumes.launches == before + 1
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    assert float(got.valid.float().mean()) > 0.5


@pytest.mark.parametrize("ths", [(20.0, 7.0), (20.0,)])
def test_fast_kernel_matches_plain_at_the_level_shapes(ths):
    """The raw one-level scores (the TPU kernel's contract; the epilogue off)."""
    dev = cuda_device()
    levels = pyramid(t(two_plane_frame_source(H, W)(2)[0], dev), VOConfig.kitti().orb)
    assert [tuple(x.shape) for x in levels[::7]] == [(376, 1241), (106, 346)]
    for img in levels:
        got = _launched(TF.fast_scores, TF.fast_scores_levels, img, ths)
        want = TF.fast_scores_plain(img, ths)
        assert len(got) == len(ths)
        for g, w in zip(got, want):
            assert torch.equal(g, w), tuple(img.shape)
    assert float(got[0].max()) > 0  # corners found


@pytest.mark.parametrize("ths", [(20.0, 7.0), (20.0,)])
@pytest.mark.parametrize("kind", ["frame", "integers"])
def test_fast_levels_kernel_matches_plain_at_the_level_shapes(ths, kind):
    """The 8 kitti() levels of a 1241x376 frame in one launch, border 19,
    bit-equal to the plain version; "integers" is an integer-valued
    texture, whose integer scores tie often under the NMS."""
    dev = cuda_device()
    rng = np.random.RandomState(3)
    img = two_plane_frame_source(H, W)(2)[0] if kind == "frame" else np.round(rng.uniform(0, 255, (H, W)))
    levels = pyramid(t(img.astype(np.float32), dev), VOConfig.kitti().orb)
    if kind == "integers":
        levels = [torch.round(x) for x in levels]
    got = _launched(TF.fast_scores_levels, TF.fast_scores_levels, levels, ths, 19)
    want = TF.fast_scores_levels_plain(levels, ths, 19)
    for img_l, maps, plain in zip(levels, got, want):
        assert len(maps) == len(ths)
        for g, w in zip(maps, plain):
            assert torch.equal(g, w), tuple(img_l.shape)
    assert float(got[0][0].max()) > 0  # corners survive the border and the NMS


@pytest.mark.parametrize("ths", [(20.0, 7.0), (20.0,)])
@pytest.mark.parametrize("border", [0, 3, 19, 40])
def test_fast_levels_kernel_matches_plain_at_ragged_shapes(ths, border):
    """Eight levels (the kernel's table) in one launch: shapes that are no
    multiple of the 30-px fused tile (32 px raw), some just past a tile
    edge (31 and 61 rows), levels the border covers whole (at 40: 61x95,
    5x7) and a 1x1 level."""
    dev = cuda_device()
    rng = np.random.RandomState(border)
    shapes = [(31, 61), (83, 139), (61, 95), (17, 33), (5, 7), (1, 1), (33, 31), (97, 307)]
    levels = [t(np.round(rng.uniform(0, 255, s)).astype(np.float32), dev) for s in shapes]
    got = _launched(TF.fast_scores_levels, TF.fast_scores_levels, levels, ths, border)
    for img_l, maps, plain in zip(levels, got, TF.fast_scores_levels_plain(levels, ths, border)):
        for g, w in zip(maps, plain):
            assert torch.equal(g, w), (tuple(img_l.shape), border)


def test_orb_with_fast_kernel_equals_rolled_ring():
    """The 19-px border mask hides the zero halo: the same keypoints, from
    one launch for the frame's 8 levels."""
    dev = cuda_device()
    img = t(two_plane_frame_source(H, W)(2)[0], dev)
    k = VOConfig.kitti().orb
    a = _launched(extract_orb, TF.fast_scores_levels, img, dataclasses.replace(k, fast_backend="pallas"))
    b = extract_orb(img, dataclasses.replace(k, fast_backend="xla"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("K", [512, 77, 0, 1, 255, 256, 257, 2048])
def test_motion_hessian_kernel_matches_plain(K):
    dev = cuda_device()
    rng = np.random.RandomState(K)
    c = CameraConfig()
    X = np.stack([rng.uniform(-20, 20, K), rng.uniform(-5, 5, K), rng.uniform(5, 60, K)], -1).astype(np.float32)
    pc = X + np.array([0.3, -0.1, 0.5], np.float32)
    uv = np.stack([c.fx * pc[:, 0] / pc[:, 2] + c.cx, c.fy * pc[:, 1] / pc[:, 2] + c.cy], -1)
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    m = ((rng.rand(K) > 0.1) & (pc[:, 2] > 0.5)).astype(np.float32)
    # evaluated off the true pose, as tests/test_ba_hessian.py does: at the
    # true pose g is a sum of pure noise that cancels below its tolerance
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.35, -0.1, 0.46]
    intr = TB.motion_intrinsics(Camera.from_config(c, dev))
    Xt, uvt = np.ascontiguousarray(X.T), np.ascontiguousarray(uv.T)  # the kernel takes contiguous rows
    args = (t(T, dev), t(Xt, dev), t(uvt, dev), t(m[None], dev), intr, 5.991 ** 0.5)
    got = _launched(TB.motion_hessian_gradient, TB.motion_hessian_gradient, *args)
    want = TB.motion_hessian_gradient_plain(*args)
    for name, a, b in zip(("H", "g"), got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6 * max(float(b.abs().max()), 1e-30), msg=name)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    again = TB.motion_hessian_gradient(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # a fixed summation order: deterministic
    assert torch.equal(got[0], got[0].T)


@pytest.mark.parametrize("Q", [1, 512, 2048, 2049])
@pytest.mark.parametrize("T", [1, 511, 512, 513])
def test_hamming_matrix_kernel_matches_plain(Q, T):
    """The matcher's shapes (Q=2048 and 512 against T=512) and ragged ones:
    a T that is no multiple of the 4 columns a thread stores, a Q off the
    block's rows."""
    dev = cuda_device()
    rng = np.random.RandomState(Q + T)
    q, tr = random_desc(rng, Q), random_desc(rng, T)
    qi, ti = min(4, Q - 1), min(9, T - 1)
    tr[ti] = q[qi]
    args = (t(q, dev), t(tr, dev))
    got = _launched(TH.hamming_distance_matrix_pallas, TH.hamming_distance_matrix_pallas, *args)
    assert torch.equal(got, TH.hamming_distance_matrix(*args)) and int(got[qi, ti]) == 0


def test_hamming_matrix_kernel_refuses_a_misaligned_view():
    dev = cuda_device()
    words = t(random_desc(np.random.RandomState(0), 65), dev).reshape(-1)
    shifted = words[1 : 1 + 64 * 8].view(64, 8)  # contiguous, 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        TH.hamming_distance_matrix_pallas(shifted, words[: 64 * 8].view(64, 8))


def _ba_problem(dev, F, L, stereo, seed=0):
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)], -1).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    poses[:, 0, 3] = -0.8 * np.arange(F)
    poses[:, 2, 3] = 0.3 * np.arange(F)
    c = CameraConfig()
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    u = c.fx * pc[..., 0] / pc[..., 2] + c.cx
    v = c.fy * pc[..., 1] / pc[..., 2] + c.cy
    obs = (np.stack([u, v], -1) + rng.normal(0, 1.5, (F, L, 2))).astype(np.float32)
    mask = (pc[..., 2] > 0.5) & (rng.rand(F, L) < 0.8)
    args = [t(a, dev) for a in (poses, X, obs, mask)] + [Camera.from_config(c, dev), 5.991 ** 0.5]
    if stereo:
        ur = (u - c.bf / pc[..., 2] + rng.normal(0, 1.2, u.shape)).astype(np.float32)
        args += [t(ur, dev), t(mask & (rng.rand(F, L) > 0.3), dev)]
    return args


@pytest.mark.parametrize("F,L,stereo", [(4, 2048, True), (4, 2048, False), (8, 517, True), (1, 5, False)])
def test_local_ba_kernel_matches_plain(F, L, stereo):
    dev = cuda_device()
    args = _ba_problem(dev, F, L, stereo)
    got = _launched(TB.local_ba_blocks, TB.local_ba_blocks, *args)
    want = TB.local_ba_blocks_plain(*args)
    for name, a, b in zip(("Hcc", "Hcp", "Hpp", "gc", "gp"), got, want):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=1e-4 * max(float(b.abs().max()), 1.0), msg=name)
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=0)
    again = TB.local_ba_blocks(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # a fixed summation order: deterministic


def _assert_blocks_close(got, want):
    for name, a, b in zip(("Hcc", "Hcp", "Hpp", "gc", "gp"), got, want):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=1e-4 * max(float(b.abs().max()), 1.0), msg=name)
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=0)


@pytest.mark.parametrize("F", [1, 4, 8, 36])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 33, 65, 2047, 2049])
def test_local_ba_kernel_matches_plain_at_ragged_shapes(F, L):
    """Warps and blocks cut by L on either side of 16, 32 and 64 landmarks,
    and F past one round of frames; stereo on odd L.  Evaluated 0.2 m off the true
    landmarks, as tests/test_ba_hessian.py evaluates off the true pose: at
    the truth gc and gp are sums of pure noise that cancel below the
    tolerance (with one frame, gp is one observation's three rows)."""
    dev = cuda_device()
    args = _ba_problem(dev, F, L, stereo=L % 2 == 1, seed=F + L)
    args[1] = args[1] + 0.2
    got = _launched(TB.local_ba_blocks, TB.local_ba_blocks, *args)
    _assert_blocks_close(got, TB.local_ba_blocks_plain(*args))
    again = TB.local_ba_blocks(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_local_ba_kernel_ticket_resets_between_builds():
    """100 builds back to back on one stream, F and L changing from call to
    call, one-shot builds between those of five bound builds, each with its
    own ticket that every launch must leave at zero: each equals its shape's
    first result bit for bit."""
    dev = cuda_device()
    shapes = [(4, 2048), (1, 17), (8, 517), (36, 100), (3, 2049)]
    problems = [_ba_problem(dev, F, L, stereo=i % 2 == 0, seed=i) for i, (F, L) in enumerate(shapes)]
    bound = [TB.LocalBABuild(obs, mask, cam, d, *rest) for _, _, obs, mask, cam, d, *rest in problems]
    first = [TB.local_ba_blocks(*p) for p in problems]
    for p, f in zip(problems, first):
        _assert_blocks_close(f, TB.local_ba_blocks_plain(*p))
    for i in range(100):
        k = (3 * i) % len(shapes)
        p = problems[k]
        got = bound[k](p[0], p[1]) if i % 2 else TB.local_ba_blocks(*p)
        assert all(torch.equal(a, b) for a, b in zip(got, first[k])), (i, shapes[k])


def _device_events(fn):
    """The device-side events (kernels, copies, fills) of one ``fn()``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_bound_builds_launch_one_kernel_and_nothing_else():
    dev = cuda_device()
    poses, X, obs, mask, cam, delta, ur, rm = _ba_problem(dev, 4, 2048, True)
    local = TB.LocalBABuild(obs, mask, cam, delta, ur, rm)
    names = _device_events(lambda: local(poses, X))
    assert len(names) == 1 and "local_ba_blocks_kernel" in names[0], names
    K = 512
    rng = np.random.RandomState(3)
    Xt = t(np.stack([rng.uniform(-20, 20, K), rng.uniform(-5, 5, K), rng.uniform(5, 60, K)]).astype(np.float32), dev)
    uvt = t(rng.uniform(0, 600, (2, K)).astype(np.float32), dev)
    maskf = t((rng.rand(1, K) > 0.1).astype(np.float32), dev)
    motion = TB.MotionBuild(Xt, uvt, maskf, TB.motion_intrinsics(cam), delta)
    T = torch.eye(4, device=dev)
    names = _device_events(lambda: motion(T))
    assert len(names) == 1 and "motion_hessian_kernel" in names[0], names


def test_bound_builds_launch_on_their_own_card_while_another_is_current():
    """A build bound on the second card, called while the first is current,
    launches on the second card and equals a step made with it current."""
    cuda_device()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    poses, X, obs, mask, cam, delta, ur, rm = _ba_problem(dev, 4, 2048, True, seed=5)
    Xt, uvt = X[:512].T.contiguous(), obs[0, :512].T.contiguous()
    maskf = mask[0, :512].to(torch.float32)[None]
    local = TB.LocalBABuild(obs, mask, cam, delta, ur, rm)
    motion = TB.MotionBuild(Xt, uvt, maskf, TB.motion_intrinsics(cam), delta)
    with torch.cuda.device(1):
        want = [x.clone() for x in (*local(poses, X), *motion(poses[1]))]
    torch.cuda.synchronize(1)
    with torch.cuda.device(0):
        got = (*local(poses, X), *motion(poses[1]))
    torch.cuda.synchronize(1)
    assert all(x.device == dev and torch.equal(x, y) for x, y in zip(got, want))
    _assert_blocks_close(got[:6], TB.local_ba_blocks_plain(poses, X, obs, mask, cam, delta, ur, rm))


class _OneShotLocal:
    """LocalBABuild's interface over fresh public calls, one a step."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __call__(self, poses, points):
        return TB.local_ba_blocks(poses, points, *self.args)


class _OneShotMotion:
    """MotionBuild's interface over a fresh build a step, as the public
    call makes (which would find this class in place of MotionBuild)."""

    build = TB.MotionBuild

    def __init__(self, *args, **kwargs):
        self.args = args

    def __call__(self, T):
        return self.build(*self.args)(T)


def test_lm_loops_on_bound_builds_equal_loops_of_one_shot_calls(monkeypatch):
    """local_ba (5 steps, stereo) and motion_only_ba (10 steps, trim 10 px)
    give bit-equal results whether each step's build is the loop's bound
    build or a fresh public call."""
    from stereo_semantic_vo_tpu_torch.core.config import BAConfig
    from stereo_semantic_vo_tpu_torch.ops import ba as ops_ba
    from stereo_semantic_vo_tpu_torch.ops import local_ba as ops_local

    dev = cuda_device()
    poses, X, obs, mask, cam, delta, ur, rm = _ba_problem(dev, 4, 2048, True, seed=11)
    X0 = X + 0.1
    L = X.shape[0]
    cfg = BAConfig(local_hessian_backend="pallas", hessian_backend="pallas", trim_px=10.0)

    def run():
        a = ops_local.local_ba(poses, X0, obs, mask, torch.ones(L, dtype=torch.bool, device=dev), cam, cfg,
                               obs_ur=ur, obs_r_mask=rm)
        b = ops_ba.motion_only_ba(poses[1], X, obs[1], mask[1], cam, cfg)
        return (*a, *b)

    launches = TB.local_ba_blocks.launches, TB.motion_hessian_gradient.launches
    bound = run()
    assert TB.local_ba_blocks.launches == launches[0] + cfg.local_iterations
    assert TB.motion_hessian_gradient.launches == launches[1] + cfg.iterations
    monkeypatch.setattr(ops_local, "LocalBABuild", _OneShotLocal)
    monkeypatch.setattr(TB, "MotionBuild", _OneShotMotion)
    one_shot = run()
    for a, b in zip(bound, one_shot):
        assert torch.equal(a, b)


def test_dense_track_step_and_refine_read_nothing_back():
    """The dense stereo step and the window refine stay on the device."""
    dev = cuda_device()
    k = VOConfig.kitti()
    cfg = dataclasses.replace(
        k, camera=CameraConfig(width=320, height=240),
        orb=dataclasses.replace(k.orb, max_keypoints=256, n_levels=3),
        stereo=dataclasses.replace(k.stereo, sparse_mode="dense"),
    )
    src = two_plane_frame_source(240, 320)
    boxes, bv = torch.zeros((32, 4), device=dev), torch.zeros(32, dtype=torch.bool, device=dev)
    state, _ = TT.init_step(init_state(cfg, dev), TT.FrameInput(*(t(a, dev) for a in src(0)), boxes, bv), cfg)
    for i in range(1, 4):
        state, _ = TT.track_step(state, TT.FrameInput(*(t(a, dev) for a in src(i)), boxes, bv), cfg)
    frame = TT.FrameInput(*(t(a, dev) for a in src(4)), boxes, bv)
    launches = TG.sgm_aggregate_batch.launches, TB.local_ba_blocks.launches, TCV.cost_volumes.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        refined = refine_state(state, cfg)
        _, out = TT.track_step(refined, frame, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(out.pnp_ok) and int(out.n_stereo) > 50
    assert TG.sgm_aggregate_batch.launches == launches[0] + 4  # left + right, then refine
    assert TB.local_ba_blocks.launches == launches[1] + cfg.ba.local_iterations
    assert TCV.cost_volumes.launches == launches[2] + 1  # both volumes of the frame


@pytest.mark.parametrize("knobs", [False, True])
def test_track_step_reads_nothing_back(knobs):
    """Every guard of the step stays on the device: PyTorch's sync debug mode
    raises on a synchronizing call (a prototype that may miss some).  With
    the knobs on, the step runs the FAST kernel once for all levels and the
    fused motion-BA build at each LM iteration."""
    dev = cuda_device()
    k = VOConfig.kitti()
    cfg = dataclasses.replace(
        k, camera=CameraConfig(width=320, height=240),
        orb=dataclasses.replace(k.orb, max_keypoints=256, n_levels=3, fast_backend="pallas" if knobs else "auto"),
        ba=dataclasses.replace(k.ba, hessian_backend="pallas" if knobs else "auto"),
    )
    src = two_plane_frame_source(240, 320)
    boxes, bv = torch.zeros((32, 4), device=dev), torch.zeros(32, dtype=torch.bool, device=dev)
    state, _ = TT.init_step(init_state(cfg, dev), TT.FrameInput(*(t(a, dev) for a in src(0)), boxes, bv), cfg)
    frame = TT.FrameInput(*(t(a, dev) for a in src(1)), boxes, bv)
    launches = TF.fast_scores_levels.launches, TB.motion_hessian_gradient.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = TT.track_step(state, frame, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(out.pnp_ok)
    n_fast, n_motion = (1, cfg.ba.iterations) if knobs else (0, 0)  # B4: one launch for the 3 levels
    assert TF.fast_scores_levels.launches == launches[0] + n_fast
    assert TB.motion_hessian_gradient.launches == launches[1] + n_motion


# --- the online detector (models/yolo.py) and its side stream (engine/pipeline.py)

DET_RTOL, DET_ATOL_REL, DET_BOX_TOL_PX = 1e-4, 1e-4, 1e-2


def _smoke_gray(i=0):
    return torch.from_numpy(two_plane_frame_source(H, W)(i)[0] / 255.0)


@pytest.mark.parametrize("which", ["kitti_tiny_v2", "tiny_v3"])
def test_detector_on_the_card_matches_the_cpu(which):
    """The same random weights on the card (cuDNN, TF32 off) and on the CPU:
    head maps within rtol 1e-4 / atol 1e-4 x max|CPU|; kitti_tiny_v2's
    detections on a 1241x376 frame with equal valid masks and boxes within
    1e-2 px where valid."""
    dev = cuda_device()
    gpu, cpu = getattr(zoo, which)(device=dev), getattr(zoo, which)(device="cpu")
    img = _smoke_gray()
    for (_, a), (_, b) in zip(gpu.heads(img.to(dev)), cpu.heads(img)):
        a = a.cpu()
        assert torch.allclose(a, b, rtol=DET_RTOL, atol=DET_ATOL_REL * float(b.abs().max()))
    if which == "kitti_tiny_v2":
        got, want = gpu.detect(img.to(dev)), cpu.detect(img)
        assert torch.equal(got.valid.cpu(), want.valid) and bool(want.valid.any())
        v = want.valid
        assert float((got.boxes.cpu()[v] - want.boxes[v]).abs().max()) <= DET_BOX_TOL_PX


def _online_cfg(max_boxes=32):
    k = VOConfig.kitti()
    return dataclasses.replace(
        k, camera=CameraConfig(width=320, height=240),
        orb=dataclasses.replace(k.orb, max_keypoints=256, n_levels=3),
        semantic=dataclasses.replace(k.semantic, max_boxes=max_boxes),
    )


def test_detect_and_an_async_dispatch_read_nothing_back():
    """``detect`` and a frame's ``process_frame`` with a pending detection
    (the main stream waits on its event, the next detection is queued on the
    side stream) run under sync debug mode; the deferred readback of the
    frame before, the pipeline's one sync point, is set aside for it."""
    dev = cuda_device()
    det = zoo.kitti_tiny_v2(conf_threshold=0.01, device=dev)
    img = _smoke_gray().to(dev)
    det.detect(img)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = det.detect(img)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(out.valid.any())
    cfg = _online_cfg()
    src = two_plane_frame_source(240, 320)
    pipe = VOPipeline(cfg, device=dev, detector=det, write_trajectory=False)
    pipe.process_frame(*src(0), None, None, 0.0)
    held = []
    pipe._finalize = lambda out, *rest: held.append(out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.process_frame(*src(1), None, None, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(held) == 1 and bool(pipe._pending[0].pnp_ok)


class _SlowDetector:
    """A detector whose every call first keeps its stream busy for ~50 ms."""

    def __init__(self, det):
        self.det, self.device = det, det.device

    def detect(self, img):
        torch.cuda._sleep(100_000_000)
        return self.det.detect(img)


@pytest.mark.parametrize("capture", [False, True], ids=["eager", "graphs"])
def test_side_stream_detection_is_awaited_by_the_next_frame(capture):
    """Frame t+1's step sees detect(frame t) although detection, on its side
    stream, ends long after the main stream reached the step: the main
    stream waits on detection's event, and the boxes are not reused early.
    The boxes a step read are copied on the main stream right after it
    (under graphs, from the static buffer the next frame overwrites)."""
    dev = cuda_device()
    nb = 128
    det = zoo.kitti_tiny_v2(conf_threshold=0.01, max_boxes=nb, device=dev)
    cfg = _online_cfg(nb)
    src = two_plane_frame_source(240, 320)
    seen = []
    pipe = VOPipeline(cfg, device=dev, detector=_SlowDetector(det), write_trajectory=False, capture=capture)
    for i in range(4):
        pipe.process_frame(*src(i), None, None, 0.1 * i)
        if i > 0:
            seen.append((pipe.steps.frame.boxes.clone(), pipe.steps.frame.boxes_valid.clone()))
    pipe.flush()
    assert len(seen) == 3
    for i, (boxes, valid) in enumerate(seen):
        want = det.detect(torch.from_numpy(src(i)[0]).to(dev) / 255.0)
        assert torch.equal(valid, want.valid) and bool(valid.any())
        assert float((boxes[valid] - want.boxes[want.valid]).abs().max()) <= DET_BOX_TOL_PX


# --- steered BRIEF, the volume stereo modes and parallel/ (dp tracker,
# landmark-sharded BA over NCCL)

STEER_BITS_MAX = 0.005  # of the valid keypoints' descriptor bits, card vs CPU


def _steer_cfg():
    k = VOConfig.kitti()
    return dataclasses.replace(k, orb=dataclasses.replace(k.orb, steer=True))


def test_steered_orb_on_the_card_matches_the_cpu():
    """Steered ORB at 1241x376, K=512, 8 levels: keypoints exact, B1 once;
    responses within rtol 1e-6 (the pyramid's resize matmuls round in
    cuBLAS's order on the card); the moments (cuBLAS against the CPU's sum
    order) may turn an angle by an ulp and flip a few bits: at most 0.5%."""
    dev = cuda_device()
    cfg = _steer_cfg()
    img = torch.from_numpy(two_plane_frame_source(H, W)(3)[0])
    before = TP.extract_patches_levels.launches
    got = extract_orb(img.to(dev), cfg.orb)
    torch.cuda.synchronize()
    assert TP.extract_patches_levels.launches == before + 1
    want = extract_orb(img, cfg.orb)
    for f in ("uv", "level", "valid"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.allclose(got.response.cpu(), want.response, rtol=1e-6, atol=0.0)
    v = want.valid
    x = (got.desc.cpu()[v] ^ want.desc[v]).numpy().view(np.uint8)
    differ = int(np.unpackbits(x).sum())
    assert differ <= STEER_BITS_MAX * int(v.sum()) * 256, differ
    assert float((got.angle.cpu() - want.angle).abs().max()) < 1e-2


@pytest.mark.parametrize("mode", ["volume", "volume2"])
def test_volume_modes_on_the_card_match_the_cpu_and_strips(mode):
    """At 1241x376 with K=512 ORB keypoints: the card against the CPU (valid
    equal, disparity within 1e-4 px) and against B2 ("pallas") where the
    right strip is not clamped (ROADMAP C: the clamped strip reads
    disparity d at d - shift)."""
    dev = cuda_device()
    cfg = VOConfig.kitti()
    left, right = (torch.from_numpy(a) for a in two_plane_frame_source(H, W)(3))
    kp = extract_orb(left, cfg.orb)
    sc = dataclasses.replace(cfg.stereo, sparse_mode=mode)
    cpu = sparse_disparity(left, right, kp.uv, kp.valid, Camera.from_config(cfg.camera, "cpu"), sc)
    cam = Camera.from_config(cfg.camera, dev)
    args = (left.to(dev), right.to(dev), kp.uv.to(dev), kp.valid.to(dev), cam)
    card = sparse_disparity(*args, sc)
    b2 = sparse_disparity(*args, dataclasses.replace(cfg.stereo, sparse_mode="pallas"))
    assert torch.equal(card.valid.cpu(), cpu.valid) and int(cpu.valid.sum()) > 200
    assert float((card.disparity.cpu() - cpu.disparity).abs().max()) <= 1e-4
    inside = TS.keypoint_origins(kp.uv, H, W, cfg.stereo.max_disparity, cfg.stereo.block_radius)[3].to(dev) == 0
    assert torch.equal(card.valid[inside], b2.valid[inside])
    assert float((card.disparity[inside] - b2.disparity[inside]).abs().max()) <= 1e-4


def _dp_frames(dev, ts):
    src = two_plane_frame_source(H, W)
    imgs = [src(i) for i in ts]
    boxes = torch.zeros((len(ts), 32, 4), device=dev)
    valid = torch.zeros((len(ts), 32), dtype=torch.bool, device=dev)
    return TT.FrameInput(*(torch.from_numpy(np.stack([im[j] for im in imgs])).to(dev) for j in (0, 1)), boxes, valid)


def test_dp_streams_equal_single_stream_runs_and_read_nothing_back():
    """Three streams on one card, each replaying its graphs on its own CUDA
    stream, starting at steps 0, 1, 2 on offset frames: each stream's
    outputs and state equal, bit for bit, its own init_step / track_step
    run; the last step, which only replays (each stream captured its
    init and track graphs in the steps before), raises nothing under sync
    debug mode."""
    from stereo_semantic_vo_tpu_torch.parallel import dp_tracker as TDP

    dev = cuda_device()
    cfg = dataclasses.replace(VOConfig.kitti(), camera=CameraConfig(width=W, height=H))
    B, steps = 3, 4
    step = TDP.make_dp_tracker([dev], cfg)
    states = TDP.batched_init_state(cfg, B, [dev])
    singles, outs = [None] * B, []
    for s in range(steps):
        frames = _dp_frames(dev, [s + b for b in range(B)])
        for b in range(B):
            if s == b:
                states[b] = init_state(cfg, dev)
                singles[b] = (init_state(cfg, dev), [])
        if s == steps - 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            states, out = step(states, frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(out)
        for b in range(B):
            if singles[b] is not None:
                st, seq = singles[b]
                st, o = (TT.init_step if int(st.frame_idx) < 0 else TT.track_step)(
                    st, TT.FrameInput(*(x[b] for x in frames)), cfg)
                singles[b] = (st, seq + [(s, o)])
    torch.cuda.synchronize()
    for b in range(B):
        st, seq = singles[b]
        for s, o in seq:
            for name, x in zip(o._fields, o):
                assert torch.equal(getattr(outs[s], name)[b], x), (b, s, name)
        for name, x in st._asdict().items():
            y = getattr(states[b], name)
            assert torch.equal(x, y), (b, name)
    assert all(bool(outs[-1].pnp_ok[b]) for b in range(B))
    assert [step.steps[b].graphs["track_step"].replays for b in range(B)] == [2, 1, 1]


def _dp_run(cfg, dev, capture, steps, starts):
    """The dp tracker over ``steps`` steps, stream b restarting from a
    fresh state at ``starts[b]`` on the frames s + 2b.  -> (step, outputs
    of each step, final states, launches of each kernel)."""
    from stereo_semantic_vo_tpu_torch.kernels import launch_counters
    from stereo_semantic_vo_tpu_torch.parallel import dp_tracker as TDP

    counters = launch_counters()
    before = {name: k.launches for name, k in counters.items()}
    step = TDP.make_dp_tracker([dev], cfg, capture=capture)
    states = TDP.batched_init_state(cfg, len(starts), [dev])
    outs = []
    for s in range(steps):
        frames = _dp_frames(dev, [s + 2 * b for b in range(len(starts))])
        for b, start in enumerate(starts):
            if s == start and s > 0:
                states[b] = init_state(cfg, dev)
        if s == steps - 1 and capture:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            states, out = step(states, frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(out)
    torch.cuda.synchronize()
    return step, outs, states, {name: k.launches - before[name] for name, k in counters.items()}


def test_dp_graphs_equal_eager_and_single_stream_runs():
    """Two streams, stream 1 restarting at step 1 (its init and track
    graphs captured a step after stream 0's): the graph run equals the
    eager run (``capture=False``) and each stream's own single-stream run
    bit for bit, with the same kernel launches; a replayed step raises
    nothing under sync debug mode; each stream holds a pool of its own."""
    dev = cuda_device()
    cfg = dataclasses.replace(VOConfig.kitti(), camera=CameraConfig(width=W, height=H))
    steps, starts = 4, (0, 1)
    eager = _dp_run(cfg, dev, False, steps, starts)
    graph = _dp_run(cfg, dev, True, steps, starts)
    assert graph[3] == eager[3] and graph[3]["extract_patches"] == 2 * steps
    sg = graph[0].steps
    assert all(sg[b].capture for b in (0, 1)) and not any(eager[0].steps[b].capture for b in (0, 1))
    assert sg[0].pool != sg[1].pool
    assert [sg[b].graphs["track_step"].replays for b in (0, 1)] == [2, 1]
    for s, (a, b) in enumerate(zip(eager[1], graph[1])):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), (s, name)
    for b in (0, 1):
        for name, x, y in zip(eager[2][b]._fields, eager[2][b], graph[2][b]):
            assert torch.equal(x, y), (b, name)
        st = init_state(cfg, dev)
        for s in range(starts[b], steps):
            fr = _dp_frames(dev, [s + 2 * i for i in range(2)])
            st, o = (TT.init_step if s == starts[b] else TT.track_step)(st, TT.FrameInput(*(x[b] for x in fr)), cfg)
            for name, x in zip(o._fields, o):
                assert torch.equal(getattr(graph[1][s], name)[b], x), (b, s, name)
        for name, x, y in zip(st._fields, st, graph[2][b]):
            assert torch.equal(x, y), (b, name)


@pytest.mark.parametrize("capture", [False, True], ids=["eager", "graph"])
def test_dp_rewinds_a_stream_from_a_state_it_handed_out(capture):
    """Two streams over four steps; at step 3 stream 0 is given back the
    very state object the tracker handed out after step 1.  That state
    keeps step 1's values through the later steps, and step 3 tracks from
    it: its outputs and state equal, bit for bit, an eager track_step from
    a copy of it, while stream 1 runs on."""
    from stereo_semantic_vo_tpu_torch.engine.state import VOState
    from stereo_semantic_vo_tpu_torch.parallel import dp_tracker as TDP

    dev = cuda_device()
    cfg = dataclasses.replace(VOConfig.kitti(), camera=CameraConfig(width=W, height=H))
    step = TDP.make_dp_tracker([dev], cfg, capture=capture)
    states = TDP.batched_init_state(cfg, 2, [dev])
    outs = []
    for s in range(4):
        if s == 3:
            states = [kept, states[1]]
        states, out = step(states, _dp_frames(dev, [s, s + 2]))
        outs.append(out)
        if s == 1:
            kept = states[0]
            snap = VOState(*(x.clone() for x in kept))
    torch.cuda.synchronize()
    assert all(sg.capture == capture for sg in step.steps.values())
    for name, x, y in zip(snap._fields, snap, kept):
        assert torch.equal(x, y), name
    want, o = TT.track_step(snap, TT.FrameInput(*(x[0] for x in _dp_frames(dev, [3, 5]))), cfg)
    for name, x in zip(o._fields, o):
        assert torch.equal(getattr(outs[3], name)[0], x), name
    for name, x, y in zip(want._fields, want, states[0]):
        assert torch.equal(x, y), name
    assert (int(states[0].frame_idx), int(states[1].frame_idx)) == (2, 3)


def _ba_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_ba_one_rank_over_nccl_equals_local_ba():
    """``make_sharded_local_ba`` at world size 1 over NCCL, in this process,
    against ``local_ba`` with the same einsum build (equal: an all-reduce
    over one rank is the identity) and with B7 (tests/test_sharded_ba.py's
    bounds: cost rtol 1e-3, poses atol 5e-3, median point difference under
    0.05 m); one sharded solve reads nothing back."""
    import torch.distributed as dist

    from stereo_semantic_vo_tpu_torch.core.config import BAConfig
    from stereo_semantic_vo_tpu_torch.ops.local_ba import local_ba
    from stereo_semantic_vo_tpu_torch.parallel import mesh as TM
    from stereo_semantic_vo_tpu_torch.parallel.sharded_ba import make_sharded_local_ba

    dev = cuda_device()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_ba_free_port()}", world_size=1, rank=0)
    try:
        mesh = TM.make_mesh(device="cuda")
        assert mesh.device == dev and mesh.size == 1
        poses, X, obs, mask, cam, delta, ur, rm = _ba_problem(dev, 4, 2048, True, seed=2)
        X0, pv = X + 0.1, torch.ones(2048, dtype=torch.bool, device=dev)
        cfg = BAConfig(local_iterations=5)
        run = make_sharded_local_ba(mesh, cam, cfg, stereo_edges=True)
        got = run(poses, X0, obs, mask, pv, ur, rm)
        want = local_ba(poses, X0, obs, mask, pv, cam, cfg, obs_ur=ur, obs_r_mask=rm)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        b7 = local_ba(poses, X0, obs, mask, pv, cam, dataclasses.replace(cfg, local_hessian_backend="pallas"),
                      obs_ur=ur, obs_r_mask=rm)
        assert abs(float(got.cost) - float(b7.cost)) <= 1e-3 * abs(float(b7.cost))
        assert float((got.poses - b7.poses).abs().max()) <= 5e-3
        assert float(torch.median(torch.linalg.vector_norm(got.points - b7.points, dim=1))) < 0.05
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run(poses, X0, obs, mask, pv, ur, rm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        dist.destroy_process_group()


def test_sharded_ba_two_ranks_over_nccl():
    """Two processes, a card each, NCCL: each rank's sharded solve against
    a process-local ``local_ba`` (tests/torch_sharded_ba_worker.py)."""
    import os
    import subprocess
    import sys

    cuda_device()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sharded_ba_worker.py")
    coord = f"127.0.0.1:{_ba_free_port()}"
    procs = [subprocess.Popen([sys.executable, worker, coord, "2", str(pid), "cuda"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "PARITY_OK" in out and "ranks=2" in out, out


# ---------------------------------------------------------------------------
# detector training and checkpoint resume
# ---------------------------------------------------------------------------

# 64x64, batch 4: three conv-BN-leaky blocks and a region head (the JAX
# package's tests/test_yolo_train.py TRAIN_CFG with burn-in off and lr 0.003,
# so that three steps move the params)
TRAIN_CFG = """
[net]
batch=4
width=64
height=64
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.003
burn_in=0
policy=constant

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
size=1
stride=1
pad=1
filters=30
activation=linear

[region]
anchors = 0.5,0.5, 1.0,1.0, 2.0,2.0, 1.0,2.0, 2.0,1.0
bias_match=1
classes=1
coords=4
num=5
softmax=1
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
thresh=.6
rescore=0
"""
# its region head swapped for a two-scale yolo head pair (route, upsample)
YOLO_TRAIN_CFG = TRAIN_CFG.split("[convolutional]\nsize=1")[0] + """[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 3,4,5
anchors = 6,8, 10,14, 18,22, 24,30, 34,40, 48,56
classes=2
num=6
ignore_thresh=.5

[route]
layers = -3

[upsample]
stride=2

[route]
layers = -1, -7

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 6,8, 10,14, 18,22, 24,30, 34,40, 48,56
classes=2
num=6
ignore_thresh=.5
"""
TRAIN_LOSS_RTOL, TRAIN_ATOL_REL = 1e-4, 1e-3


def _train_batch(dev, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    x[:, 8:28, 8:28] = 0.5  # constant regions: max-pool ties
    t = np.zeros((4, 8, 5), np.float32)
    m = np.zeros((4, 8), bool)
    for b, boxes in enumerate([[(0.52, 0.53, 0.25, 0.25, 1), (0.55, 0.56, 0.25, 0.25, 0)],
                               [(0.2, 0.7, 0.4, 0.45, 1)], [], [(0.8, 0.2, 0.1, 0.12, 0)]]):
        for i, box in enumerate(boxes):
            t[b, i], m[b, i] = box, True
    return tuple(torch.from_numpy(a).to(dev) for a in (x, t, m))


@pytest.mark.parametrize("cfg", [TRAIN_CFG, YOLO_TRAIN_CFG], ids=["region", "yolo"])
def test_train_steps_on_the_card_match_the_cpu(cfg):
    """Three ``train_step``s from the same seed on the card (cuDNN forward
    and backward, TF32 off) and on the CPU: loss rtol 1e-4 at each step;
    params, rolling statistics and momentum (the summed gradients) within
    atol 1e-3 x max|CPU| per leaf; the counters equal."""
    from stereo_semantic_vo_tpu_torch.models.yolo_train import YoloTrainer

    dev = cuda_device()
    gpu, cpu = YoloTrainer(cfg, seed=3, device=dev), YoloTrainer(cfg, seed=3, device="cpu")
    for s in range(3):
        lg = gpu.train_step(*_train_batch(dev, s))[0]
        lc = cpu.train_step(*_train_batch("cpu", s))[0]
        assert lg == pytest.approx(lc, rel=TRAIN_LOSS_RTOL)
    a, b = gpu.state, cpu.state
    assert (a.batch_num, a.seen) == (b.batch_num, b.seen) == (3, 12)
    for tree in ("params", "momentum"):
        for li, leaves in getattr(b, tree).items():
            for k, want in leaves.items():
                got = getattr(a, tree)[li][k].cpu()
                assert torch.allclose(got, want, rtol=0, atol=TRAIN_ATOL_REL * float(want.abs().max())), (tree, li, k)


def test_train_step_reads_nothing_back():
    """A step's dispatch (forward, losses, backward, the darknet update) under
    sync debug mode; ``train_step``'s one readback is the loss."""
    from stereo_semantic_vo_tpu_torch.models.yolo_train import YoloTrainer

    dev = cuda_device()
    for cfg in (TRAIN_CFG, YOLO_TRAIN_CFG):
        tr = YoloTrainer(cfg, seed=0, device=dev)
        batch = _train_batch(dev)
        tr.train_step(*batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, stats = tr.step(*batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert loss.is_cuda and stats.count.is_cuda and bool(torch.isfinite(loss))
        assert (tr.batch_num, tr.seen) == (2, 8)
        (graph, _), = tr.graphs.values()
        assert tr.capture and graph.replays == 1


def _same_leaves(a, b) -> bool:
    """Two trainers' params, statistics and momentum, bit for bit."""
    return all(torch.equal(x, getattr(b, tree)[li][k]) for tree in ("params", "momentum")
               for li, leaves in getattr(a, tree).items() for k, x in leaves.items())


@pytest.mark.parametrize("cfg", [TRAIN_CFG, YOLO_TRAIN_CFG], ids=["region", "yolo"])
def test_train_graph_equals_eager(cfg, monkeypatch):
    """Five steps replaying the step's CUDA graph against eager runs
    (``capture=False``) from the same state, started 8 images short of
    seen = 12800 and 2 steps short of the end of the learning rate's
    burn-in, with cuDNN held to its deterministic algorithms (its default
    choice may sum the weight gradients with atomics, and then no two
    eager runs agree): the counters equal, two eager runs equal each
    other, and two graph runs equal them, bit for bit (losses and every
    param, statistic and momentum buffer)."""
    from stereo_semantic_vo_tpu_torch.models.yolo_train import YoloTrainer

    dev = cuda_device()
    text = cfg.replace("burn_in=0", "burn_in=3")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    runs = []
    for capture in (False, True, False, True):
        tr = YoloTrainer(text, seed=2, device=dev, capture=capture)
        tr.load_state(tr.state._replace(batch_num=torch.tensor(1, dtype=torch.int32),
                                        seen=torch.tensor(12792, dtype=torch.int32)))
        losses = [tr.train_step(*_train_batch(dev, s))[0] for s in range(5)]
        runs.append((tr, losses))
    assert [tr.capture for tr, _ in runs] == [False, True, False, True]
    assert all(len(tr.graphs) == 1 for tr, _ in runs[1::2])
    assert {(tr.batch_num, tr.seen) for tr, _ in runs} == {(6, 12812)}
    for tr, losses in runs[1:]:
        assert losses == runs[0][1]
        assert _same_leaves(runs[0][0].state, tr.state)


def test_exported_weights_detect_as_the_folded_params_on_the_card():
    """After two steps on the card, ``export_weights`` loaded by
    ``YoloDetector`` and ``folded_params`` through ``from_params`` detect
    the same boxes, bit for bit (both fold the same numpy arrays)."""
    from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector
    from stereo_semantic_vo_tpu_torch.models.yolo_train import YoloTrainer

    dev = cuda_device()
    tr = YoloTrainer(TRAIN_CFG, seed=1, device=dev)
    for s in range(2):
        tr.train_step(*_train_batch(dev, s))
    img = _train_batch(dev)[0][0]
    a = YoloDetector(TRAIN_CFG, weights_bytes=tr.export_weights(), conf_threshold=0.01, device=dev).detect(img)
    b = YoloDetector.from_params(TRAIN_CFG, tr.folded_params(), conf_threshold=0.01, device=dev).detect(img)
    assert bool(b.valid.any())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_checkpoint_resume_on_the_card_is_bit_equal(tmp_path):
    """Six frames in one pipeline against three, ``save_state``,
    ``load_state`` into a fresh pipeline and three more: equal poses and
    state, bit for bit."""
    from stereo_semantic_vo_tpu_torch.utils.checkpoint import load_state, save_state

    dev = cuda_device()
    cfg = _online_cfg()
    src = two_plane_frame_source(240, 320)
    nb = cfg.semantic.max_boxes
    frames = [(i, *src(i), np.zeros((nb, 4), np.float32), np.zeros(nb, bool), 0.1 * i) for i in range(6)]
    whole = VOPipeline(cfg, device=dev, write_trajectory=False)
    whole.run(iter(frames), prefetch=False)
    first = VOPipeline(cfg, device=dev, write_trajectory=False)
    first.run(iter(frames[:3]), prefetch=False)
    save_state(str(tmp_path / "c.npz"), first.state)
    second = VOPipeline(cfg, device=dev, write_trajectory=False)
    second.resume(load_state(str(tmp_path / "c.npz"), second.state))
    assert second.state.T_cw.device == dev
    second.run(iter(frames[3:]), prefetch=False)
    for a, b in zip(whole.outputs, first.outputs + second.outputs):
        assert torch.equal(a.T_wc, b.T_wc) and torch.equal(a.obs_uid, b.obs_uid)
    for name in whole.state._fields[1:]:
        assert torch.equal(getattr(whole.state, name), getattr(second.state, name)), name


def _mover_steps(cfg, dev, n):
    """``init_step`` and ``track_step`` on ``n`` frames of chip_smoke.py's
    mover scene (1241x376, its box missed on frames t % 5 == 0)."""
    from chip_smoke import mover_frames

    state, outs = init_state(cfg, dev), []
    for i, left, right, boxes, valid, _ in mover_frames(cfg, n):
        frame = TT.FrameInput(*(t(a, dev) for a in (left, right, boxes, valid)))
        state, out = (TT.init_step if i == 0 else TT.track_step)(state, frame, cfg)
        outs.append(out)
    return outs


def test_mover_step_without_semantics_card_matches_cpu():
    """``run.py --no-semantics``'s configuration on the mover scene: the step
    after the missed frame on the card against the CPU, within 1e-3 m and
    1e-3 rad, nothing culled on either."""
    dev = cuda_device()
    cfg = dataclasses.replace(VOConfig.kitti(), use_semantics=False)
    card, cpu = _mover_steps(cfg, dev, 2)[-1], _mover_steps(cfg, torch.device("cpu"), 2)[-1]
    from chip_smoke import rotation_angle

    a, b = card.T_wc.cpu().numpy().astype(np.float64), cpu.T_wc.numpy().astype(np.float64)
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) <= 1e-3
    assert rotation_angle(a[:3, :3].T @ b[:3, :3]) <= 1e-3
    assert bool(card.pnp_ok) and int(card.n_culled_dynamic) == 0 == int(cpu.n_culled_dynamic)


def test_no_semantics_culls_nothing_on_the_card():
    """Seven mover frames on the card: with semantics the epipolar test
    culls after the missed frames; without, nothing on any frame."""
    dev = cuda_device()
    cfg = VOConfig.kitti()
    on = [int(o.n_culled_dynamic) for o in _mover_steps(cfg, dev, 7)]
    off = [int(o.n_culled_dynamic) for o in _mover_steps(dataclasses.replace(cfg, use_semantics=False), dev, 7)]
    assert sum(on) > 0, on
    assert off == [0] * 7


# --- the step as CUDA graphs (engine/graphs.py), the pipeline's default on a card


def _graph_cfg(kind):
    k = VOConfig.kitti()
    cfg = dataclasses.replace(k, camera=CameraConfig(width=320, height=240),
                              orb=dataclasses.replace(k.orb, max_keypoints=256, n_levels=3))
    if kind == "knob":
        cfg = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, fast_backend="pallas"),
                                  ba=dataclasses.replace(cfg.ba, hessian_backend="pallas"))
    if kind == "dense":
        cfg = dataclasses.replace(cfg, stereo=dataclasses.replace(cfg.stereo, sparse_mode="dense"))
    return cfg


def _graph_frames(cfg, n):
    src = two_plane_frame_source(240, 320)
    nb = cfg.semantic.max_boxes
    for i in range(n):
        boxes, valid = np.zeros((nb, 4), np.float32), np.zeros(nb, bool)
        if i == 2:  # the culling stage's in-box branch
            boxes[0], valid[0] = [100.0, 40.0, 200.0, 200.0], True
        yield (*src(i), boxes, valid, 0.1 * i)


def _graph_run(cfg, dev, n, every, capture):
    from stereo_semantic_vo_tpu_torch.kernels import launch_counters

    counters = launch_counters()
    before = {name: k.launches for name, k in counters.items()}
    pipe = VOPipeline(cfg, device=dev, local_ba_every=every, capture=capture, write_trajectory=False)
    for f in _graph_frames(cfg, n):
        pipe.process_frame(*f)
    pipe.flush()
    torch.cuda.synchronize()
    return pipe, {name: k.launches - before[name] for name, k in counters.items()}


@pytest.mark.parametrize("kind,n,every", [("sparse", 8, 0), ("knob", 8, 0), ("dense", 5, 1)])
def test_graph_replay_equals_eager_bit_for_bit(kind, n, every):
    """Every output of every frame and the final state, replaying the
    captured init / track (and, dense, refine every frame) graphs, equal the
    eager dispatch's bit for bit, with the same kernel launches."""
    dev = cuda_device()
    cfg = _graph_cfg(kind)
    eager, le = _graph_run(cfg, dev, n, every, capture=False)
    graph, lg = _graph_run(cfg, dev, n, every, capture=True)
    assert graph.steps.capture and not eager.steps.capture
    assert lg == le and lg["extract_patches"] == n
    assert lg["cost_volumes"] == (n if kind == "dense" else 0)
    assert graph.steps.graphs["track_step"].replays == n - 2
    if every:
        assert graph.steps.graphs["refine_state"].replays == n - cfg.window.window_frames
    for a, b in zip(eager.outputs, graph.outputs):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
    for name, x, y in zip(eager.state._fields, eager.state, graph.state):
        assert torch.equal(x, y), name
    assert int(graph.state.frame_idx) == n - 1 and all(bool(o.pnp_ok) for o in graph.outputs)


def test_dense_pipeline_on_the_cost_volume_kernel_equals_the_plain_loop():
    """Five frames of the dense path, a refine every frame, replaying
    graphs: ``dense_backend`` "auto" (the cost-volume kernel and B6) and
    "xla" (the plain loops) give every output of every frame and the final
    state bit for bit, one cost-volume launch a frame against none."""
    dev = cuda_device()
    cfg = _graph_cfg("dense")
    plain_cfg = dataclasses.replace(cfg, stereo=dataclasses.replace(cfg.stereo, dense_backend="xla"))
    kernel, lk = _graph_run(cfg, dev, 5, 1, capture=True)
    plain, lp = _graph_run(plain_cfg, dev, 5, 1, capture=True)
    assert lk["cost_volumes"] == 5 and lp["cost_volumes"] == 0 and lp["sgm_aggregate"] == 0
    for a, b in zip(kernel.outputs, plain.outputs):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
    for name, x, y in zip(kernel.state._fields, kernel.state, plain.state):
        assert torch.equal(x, y), name


def test_graph_capture_and_replay_read_nothing_back():
    """Four frames of a fresh pipeline under sync debug mode: the eager
    warm-up and capture of init and track, then two replays (the deferred
    readback, the pipeline's one sync point, set aside)."""
    dev = cuda_device()
    cfg = _graph_cfg("sparse")
    pipe = VOPipeline(cfg, device=dev, write_trajectory=False)
    held = []
    pipe._finalize = lambda out, *rest: held.append(out)
    frames = list(_graph_frames(cfg, 4))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames:
            pipe.process_frame(*f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pipe.steps.graphs["track_step"].replays == 2 and len(held) == 3
    assert all(bool(o.pnp_ok) for o in held) and int(pipe.state.frame_idx) == 3


SLEEP_CYCLES = 400_000_000  # ~200 ms of the main stream at the H100's 1.98 GHz


def test_process_frame_does_not_wait_on_the_frame_it_queued(monkeypatch):
    """A ~200 ms ``torch.cuda._sleep`` on the main stream after frame 4's
    replay: ``process_frame(4)`` returns long before it ends (it waits on
    frame 3's readback event alone), ``process_frame(5)`` waits for it (it
    reads frame 4), and the run equals one without the sleep bit for
    bit."""
    import time

    dev = cuda_device()
    cfg = _graph_cfg("sparse")
    frames = list(_graph_frames(cfg, 7))
    plain = VOPipeline(cfg, device=dev, write_trajectory=False)
    for f in frames:
        plain.process_frame(*f)
    plain.flush()
    pipe = VOPipeline(cfg, device=dev, write_trajectory=False)
    for f in frames[:4]:
        pipe.process_frame(*f)
    track = pipe.steps.track

    def slow_track():
        out = track()
        torch.cuda._sleep(SLEEP_CYCLES)
        return out

    torch.cuda.synchronize()
    monkeypatch.setattr(pipe.steps, "track", slow_track)
    t0 = time.perf_counter()
    pipe.process_frame(*frames[4])
    queued = time.perf_counter() - t0
    monkeypatch.setattr(pipe.steps, "track", track)
    t0 = time.perf_counter()
    pipe.process_frame(*frames[5])
    waited = time.perf_counter() - t0
    pipe.process_frame(*frames[6])
    pipe.flush()
    assert queued < 0.05 and waited > 0.1, (queued, waited)
    assert len(pipe.outputs) == len(plain.outputs) == 7
    for a, b in zip(plain.outputs, pipe.outputs):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
    assert np.array_equal(np.stack(plain.writer.poses), np.stack(pipe.writer.poses))


def test_a_capture_that_hits_a_forbidden_op_raises(monkeypatch):
    """A host read inside a captured function raises at its capture; the
    pipeline does not fall back to eager dispatch."""
    from stereo_semantic_vo_tpu_torch.engine import graphs as TGR

    dev = cuda_device()
    x = torch.ones(4, device=dev)
    g = TGR.Graph(lambda: x * float(x.sum()), TGR.capture_pool(dev), dev)
    with pytest.raises(RuntimeError):
        g()
    assert g.graph is None
    step = TGR.track_step

    def reading_step(state, frame, cfg):
        new, out = step(state, frame, cfg)
        assert int(out.n_keypoints) >= 0  # reads the count back to the host
        return new, out

    monkeypatch.setattr(TGR, "track_step", reading_step)
    cfg = _graph_cfg("sparse")
    pipe = VOPipeline(cfg, device=dev, write_trajectory=False)
    frames = list(_graph_frames(cfg, 2))
    pipe.process_frame(*frames[0])
    with pytest.raises(RuntimeError):
        pipe.process_frame(*frames[1])
    assert pipe.steps.graphs["track_step"].graph is None


# --- the sharded window refine and the replicated detector as CUDA graphs


class _OneRankNccl:
    """An in-process one-rank NCCL group on the card, destroyed on exit
    (after the graphs that hold its collectives are collected)."""

    def __enter__(self):
        import torch.distributed as dist

        from stereo_semantic_vo_tpu_torch.parallel import mesh as TMESH

        dev = cuda_device()
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_ba_free_port()}", world_size=1, rank=0)
        return TMESH.make_mesh(device="cuda")

    def __exit__(self, *exc):
        import gc

        import torch.distributed as dist

        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_sharded_runner_graph_equals_eager_bit_for_bit():
    """The standalone sharded runner at one NCCL rank: its graph (the
    first call warms up and captures, later calls replay on new inputs)
    equal, bit for bit, to the eager runner on the same inputs, with the
    all-reduces inside the capture; a replay reads nothing back."""
    from stereo_semantic_vo_tpu_torch.core.config import BAConfig
    from stereo_semantic_vo_tpu_torch.parallel.sharded_ba import make_sharded_local_ba

    with _OneRankNccl() as mesh:
        dev = mesh.device
        poses, X, obs, mask, cam, delta, ur, rm = _ba_problem(dev, 4, 2048, True, seed=3)
        pv = torch.ones(2048, dtype=torch.bool, device=dev)
        cfg = BAConfig(local_iterations=5)
        eager = make_sharded_local_ba(mesh, cam, cfg, stereo_edges=True, capture=False)
        graph = make_sharded_local_ba(mesh, cam, cfg, stereo_edges=True)
        assert not eager.graphs
        for shift in (0.1, -0.05, 0.2):
            args = (poses, X + shift, obs, mask, pv, ur, rm)
            want = eager(*args)
            got = graph(*args) if shift != 0.2 else _no_sync(lambda: graph(*args))
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        (g, _), = graph.graphs.values()
        assert g.graph is not None and g.replays == 2
        del eager, graph, g


def test_mesh_pipeline_graph_equals_eager_bit_for_bit():
    """``VOPipeline(ba_mesh=..., local_ba_every=1)`` on a one-rank NCCL
    mesh over 8 frames, refining every frame from frame 3: replaying the
    sharded refine's graph (its collectives inside) equals the eager
    dispatch bit for bit, every frame's outputs and the final state, with
    the same launches; a refine replay reads nothing back."""
    with _OneRankNccl() as mesh:
        dev = mesh.device
        cfg = _graph_cfg("sparse")
        runs = {}
        for capture in (False, True):
            from stereo_semantic_vo_tpu_torch.kernels import launch_counters

            before = {name: k.launches for name, k in launch_counters().items()}
            pipe = VOPipeline(cfg, device=dev, local_ba_every=1, ba_mesh=mesh, capture=capture,
                              write_trajectory=False)
            for f in _graph_frames(cfg, 8):
                pipe.process_frame(*f)
            pipe.flush()
            torch.cuda.synchronize()
            runs[capture] = pipe, {name: k.launches - before[name] for name, k in launch_counters().items()}
        (eager, le), (graph, lg) = runs[False], runs[True]
        assert graph.window_ba is not None and graph.steps.window_ba is graph.window_ba
        assert lg == le and lg["local_ba_blocks"] == 0
        assert graph.steps.graphs["refine_state"].replays == 8 - cfg.window.window_frames
        for a, b in zip(eager.outputs, graph.outputs):
            for name, x, y in zip(a._fields, a, b):
                assert torch.equal(x, y), name
        for name, x, y in zip(eager.state._fields, eager.state, graph.state):
            assert torch.equal(x, y), name
        _no_sync(graph.steps.refine)
        assert graph.steps.graphs["refine_state"].replays == 9 - cfg.window.window_frames
        del runs, eager, graph


@pytest.mark.parametrize("B", [2, 4])
def test_replicated_detector_graph_equals_eager_bit_for_bit(B):
    """The replicated detector on the card's data axis: its graph (one a
    device and block size; a capture, then replays on new frames) equal,
    bit for bit, to the eager batched program; a replay reads nothing
    back."""
    from stereo_semantic_vo_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from stereo_semantic_vo_tpu_torch.parallel.semantic_head import make_replicated_detector

    dev = cuda_device()
    mesh = make_mesh(1, axis=DATA_AXIS, device="cuda")
    kw = dict(conf_threshold=0.01, img_hw=(240, 320))
    eager = make_replicated_detector(mesh, zoo.KITTI_TINY_V2_CFG, capture=False, **kw)
    graph = make_replicated_detector(mesh, zoo.KITTI_TINY_V2_CFG, **kw)
    src = two_plane_frame_source(240, 320)
    for k in range(3):
        gray = torch.from_numpy(np.stack([src(k + b)[0] / 255.0 for b in range(B)]).astype(np.float32)).to(dev)
        imgs = torch.stack([gray] * 3, -1)
        want = eager(imgs)
        got = graph(imgs) if k < 2 else _no_sync(lambda: graph(imgs))
        assert tuple(got.boxes.shape) == (B, 32, 4) and bool(got.valid.any())
        for name in ("boxes", "scores", "valid", "classes"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    (g, static), = graph.graphs.values()
    assert g.replays == 2 and tuple(static.shape) == (B, 240, 320, 3) and not eager.graphs


# --- the tracer's stage stamps inside the step graphs (utils/profiling.py)


def _stamped_run(cfg, dev, n, every=0, traced=True):
    """A graph pipeline over ``n`` frames, the last ``n - 2`` replays under
    sync debug mode: -> the pipeline and its rings' records."""
    from stereo_semantic_vo_tpu_torch.utils import profiling

    profiling.enable(traced)
    try:
        pipe = VOPipeline(cfg, device=dev, local_ba_every=every, write_trajectory=False)
    finally:
        profiling.enable(True)
    held = []
    pipe._finalize = lambda out, *rest: held.append(out)
    frames = list(_graph_frames(cfg, n))
    for f in frames[:2]:
        pipe.process_frame(*f)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[2:]:
            pipe.process_frame(*f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return pipe, profiling.collect(pipe.steps.rings.values())


@pytest.mark.parametrize("kind,every", [("sparse", 0), ("dense", 1)])
def test_stamped_graphs_replay_rising_stamps_that_tile_each_call(kind, every):
    """Replays under sync debug mode write their stamps on the card: a row
    a call, every slot written, the stages in the tracker's order, stamps
    rising through each call and from call to call, so the stages tile
    each replay; the device's count of calls equals the host's.  Graphs
    captured with the tracer off hold no ring, so no stamp, and the two
    runs' states are equal bit for bit.  (The profiler's kernel counts are
    not used here: CUPTI drops kernel records in some windows.)"""
    dev = cuda_device()
    cfg = _graph_cfg(kind)
    n = 7
    pipe, trace = _stamped_run(cfg, dev, n, every)
    plain, off = _stamped_run(cfg, dev, n, every, traced=False)
    assert off.rings == [] and not plain.steps.rings
    rings = {r.name: r for r in trace.rings}
    assert rings["track_step"].stages == ["orb", "stereo", "match", "pnp", "lm", "map", "end"]
    assert rings["init_step"].stages == ["orb", "stereo", "map", "end"]
    assert len(rings["init_step"].stamps) == 1 and len(rings["track_step"].stamps) == n - 1
    for r in rings.values():
        assert int(pipe.steps.rings[r.name].count) == pipe.steps.rings[r.name].calls == len(r.stamps)
        assert np.all(r.stamps > 0)
        assert np.all(np.diff(r.stamps, axis=1) >= 0) and np.all(r.stamps[1:, 0] >= r.stamps[:-1, -1])
    if every:
        assert rings["refine_state"].stages == ["refine", "end"]
        assert len(rings["refine_state"].stamps) == n - cfg.window.window_frames + 1
    track = rings["track_step"].stamps
    assert np.array_equal(np.sum(np.diff(track, axis=1), axis=1), track[:, -1] - track[:, 0])
    assert np.all(track[:, -1] - track[:, 0] > 0)
    for name, x, y in zip(pipe.state._fields, pipe.state, plain.state):
        assert torch.equal(x, y), name
