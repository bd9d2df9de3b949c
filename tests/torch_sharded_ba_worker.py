"""Worker for the multi-process tests of the port's sharded BA: gloo on
the CPU (tests/test_torch_sharded_ba.py), NCCL with a card a rank
(tests/test_torch_cuda.py).  It imports no JAX.

Each process joins a process group of ``num_procs`` ranks, builds the
same BA problem from a fixed seed, runs the landmark-sharded Schur BA on
its own L/world landmarks (the all-reduces cross the process boundary),
all-gathers the points and checks them and the poses against a
process-local ``local_ba`` of the whole problem: at the tests' L = 64,
poses within 1e-4, points within 1e-3 and cost rtol 1e-4 (the sums over
ranks add the same terms in another order); at a larger L, where LM's
accept/reject steps amplify that order more (at L = 2048 on two gloo
ranks: points 5.7e-3 apart), tests/test_sharded_ba.py's bounds: cost rtol
1e-3, poses 5e-3, median point difference under 0.05 m.  Prints PARITY_OK
on success.

With a landmark count L (default 64) it also prints the sharded solve's
median time over 10 calls (CUDA events on a card, the host clock on the
CPU).  On a card the runner replays a CUDA graph of the solve with the
NCCL collectives inside; the worker then also runs the eager runner
(``capture=False``), prints its time, and requires a replay to equal it
bit for bit.

Usage: python torch_sharded_ba_worker.py <host:port> <num_procs> <proc_id> [cpu|cuda] [L]
"""

import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    kind = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    L = int(sys.argv[5]) if len(sys.argv) > 5 else 64

    import numpy as np
    import torch
    import torch.distributed as dist

    from stereo_semantic_vo_tpu_torch.core.camera import Camera
    from stereo_semantic_vo_tpu_torch.core.config import BAConfig, CameraConfig
    from stereo_semantic_vo_tpu_torch.ops.local_ba import local_ba
    from stereo_semantic_vo_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_landmarks
    from stereo_semantic_vo_tpu_torch.parallel.sharded_ba import make_sharded_local_ba

    if kind == "cuda":
        torch.cuda.set_device(pid)
    init_distributed(coordinator_address=coord, num_processes=n_proc, process_id=pid, device=kind)
    assert "jax" not in sys.modules
    mesh = make_mesh(device=kind)
    dev = mesh.device
    assert (mesh.size, mesh.rank) == (n_proc, pid) and (kind == "cpu" or dev.index == pid)

    cam_cfg = CameraConfig()
    cam = Camera.from_config(cam_cfg, dev)
    cfg = BAConfig(local_iterations=4)
    F = 4
    rng = np.random.RandomState(0)
    X = np.stack([rng.uniform(-8, 8, L), rng.uniform(-3, 3, L), rng.uniform(5, 30, L)], -1).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    poses[:, 0, 3] = 0.1 * np.arange(F)
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    uv = np.stack([cam_cfg.fx * pc[..., 0] / pc[..., 2] + cam_cfg.cx,
                   cam_cfg.fy * pc[..., 1] / pc[..., 2] + cam_cfg.cy], -1)
    uv = (uv + rng.randn(F, L, 2) * 0.5).astype(np.float32)
    X_noisy = (X + rng.randn(L, 3) * 0.05).astype(np.float32)
    mask = np.ones((F, L), bool)
    pv = np.ones((L,), bool)
    ur = (uv[..., 0] - cam_cfg.bf / np.maximum(X[None, :, 2], 1e-3)).astype(np.float32)
    urm = np.ones((F, L), bool)
    T = [torch.from_numpy(a).to(dev) for a in (poses, X_noisy, uv, mask, pv, ur, urm)]

    run = make_sharded_local_ba(mesh, cam, cfg, stereo_edges=True)  # a graph on a card
    res = run(T[0], shard_landmarks(mesh, T[1]), shard_landmarks(mesh, T[2], dim=1),
              shard_landmarks(mesh, T[3], dim=1), shard_landmarks(mesh, T[4]),
              shard_landmarks(mesh, T[5], dim=1), shard_landmarks(mesh, T[6], dim=1))
    points = mesh.all_gather(res.points)
    ref = local_ba(*T[:5], cam, cfg, obs_ur=T[5], obs_r_mask=T[6])
    dpose = float((res.poses - ref.poses).abs().max())
    dpts = torch.linalg.vector_norm(points - ref.points, dim=1)
    dcost = abs(float(res.cost) - float(ref.cost)) / abs(float(ref.cost))
    if L <= 64:
        assert dpose <= 1e-4 and float((points - ref.points).abs().max()) <= 1e-3 and dcost <= 1e-4
    else:
        assert dpose <= 5e-3 and float(dpts.median()) < 0.05 and dcost <= 1e-3, (dpose, float(dpts.median()), dcost)
    args = (T[0], *(shard_landmarks(mesh, T[i], dim=d) for i, d in ((1, 0), (2, 1), (3, 1), (4, 0), (5, 1), (6, 1))))

    def solve_ms(fn) -> float:
        times = []
        for _ in range(12):
            if kind == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn(*args)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[2:]))

    line = f"solve_ms={solve_ms(run):.3f}"
    if kind == "cuda":
        eager = make_sharded_local_ba(mesh, cam, cfg, stereo_edges=True, capture=False)
        got, want = run(*args), eager(*args)
        differ = [f for f, x, y in zip(got._fields, got, want) if not torch.equal(x, y)]
        assert not differ, f"the graph's replay differs from the eager runner in {differ}"
        line += f" eager_solve_ms={solve_ms(eager):.3f} graph_equals_eager=True"
        del eager, got, want
    print(f"PARITY_OK pid={pid} ranks={mesh.size} device={dev} L={L} cost={float(res.cost):.4f} "
          f"d_cost={dcost:.3g} d_pose={dpose:.3g} d_point_max={float(dpts.max()):.3g} {line}", flush=True)
    del run
    gc.collect()  # the graphs that hold the group's collectives go before the group
    if dist.is_initialized():  # one process runs without a group
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
