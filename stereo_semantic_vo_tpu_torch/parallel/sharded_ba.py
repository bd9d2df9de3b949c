"""Landmark-sharded Schur-complement bundle adjustment over a mesh's ranks.

Port of ``stereo_semantic_vo_tpu.parallel.sharded_ba``.  Each rank holds
L/world landmarks with their observations and replicated poses.  An LM
iteration, on each rank:

1. the normal-equation blocks of its own landmarks, with the plain einsum
   build (``ops/local_ba.build_normal_equations``; the reference's sharded
   body calls its "xla" build, not the block kernel);
2. the landmark blocks eliminated locally: its share of S, rhs, Hcc, gc;
3. one ``all_reduce`` of (S, rhs, Hcc, gc) packed in one buffer;
4. the (6F)^2 reduced system solved on every rank (replicated, small);
5. its own landmarks back-substituted;
6. one ``all_reduce`` of the new cost, which drives the shared
   accept/reject and damping.

So the communication an iteration is O(F^2 * 36 + F * 6) floats whatever
the landmark count.  This is ``ops/local_ba.local_ba`` with the mesh's
all-reduce as its ``reduce``.  Every rank sees the same sums, so the poses
come out equal on every rank.  Nothing reads back to the host.

The runner is the counterpart of the reference's ``jax.jit`` of its
``shard_map``: on a card it replays a CUDA graph (``core/cuda_graph.Graph``)
of the whole solve, the NCCL collectives included, captured at the first
call of each set of input shapes into a pool of its own, on static input
buffers that each call copies into; it returns copies of the graph's
outputs.  ``capture=False``, which the CPU and gloo require, runs the same
body eagerly.  ``run.body`` is that body, uncaptured, for a caller that
captures it inside a graph of its own (``engine/window_ba.WindowBA``):
a graph is not replayed inside another capture.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from stereo_semantic_vo_tpu_torch.core.camera import Camera
from stereo_semantic_vo_tpu_torch.core.config import BAConfig
from stereo_semantic_vo_tpu_torch.core.cuda_graph import Graph, capture_pool
from stereo_semantic_vo_tpu_torch.ops.local_ba import local_ba
from stereo_semantic_vo_tpu_torch.parallel.mesh import Mesh


class ShardedBAResult(NamedTuple):
    poses: torch.Tensor   # (F, 4, 4), the same on every rank
    points: torch.Tensor  # (L / world, 3): this rank's landmarks
    cost: torch.Tensor    # (), the same on every rank


def make_sharded_local_ba(
    mesh: Mesh, cam: Camera, cfg: BAConfig, fix_first_pose: bool = True, stereo_edges: bool = False,
    capture: bool | None = None,
):
    """-> run(poses, points, obs_uv, obs_mask, point_valid[, obs_ur,
    obs_r_mask]) on this rank's shards: replicated (F, 4, 4) poses, its
    (L/world, 3) points and (L/world,) point_valid, its (F, L/world)
    observation columns (``parallel/mesh.shard_landmarks(..., dim=1)``).
    With ``stereo_edges`` the runner takes the (F, L/world) stereo
    observations ``obs_ur`` / ``obs_r_mask`` too.  ``capture`` (default:
    on a CUDA device) replays the solve from a CUDA graph a set of input
    shapes (``run.graphs``: their key -> (Graph, static inputs));
    ``capture=True`` on another device raises."""
    cfg = dataclasses.replace(cfg, local_hessian_backend="xla")
    if capture is None:
        capture = mesh.device.type == "cuda"
    if capture and mesh.device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {mesh.device}")
    graphs: dict[tuple, tuple[Graph, list[torch.Tensor]]] = {}

    def body(poses, points, obs_uv, obs_mask, point_valid, obs_ur=None, obs_r_mask=None) -> ShardedBAResult:
        if stereo_edges != (obs_ur is not None and obs_r_mask is not None):
            raise ValueError(f"stereo_edges={stereo_edges} takes {'both' if stereo_edges else 'neither'} of "
                             "obs_ur and obs_r_mask")
        res = local_ba(poses, points, obs_uv, obs_mask, point_valid, cam, cfg, fix_first_pose,
                       obs_ur=obs_ur, obs_r_mask=obs_r_mask, reduce=mesh.all_reduce)
        return ShardedBAResult(poses=res.poses, points=res.points, cost=res.cost)

    def run(poses, points, obs_uv, obs_mask, point_valid, obs_ur=None, obs_r_mask=None) -> ShardedBAResult:
        args = (poses, points, obs_uv, obs_mask, point_valid, obs_ur, obs_r_mask)
        if not capture:
            return body(*args)
        key = tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args)
        if key not in graphs:
            static = [None if a is None else torch.zeros_like(a, device=mesh.device) for a in args]
            graphs[key] = (Graph(lambda: body(*static), capture_pool(mesh.device), mesh.device), static)
        graph, static = graphs[key]
        for dst, a in zip(static, args):
            if a is not None:
                dst.copy_(a)
        return ShardedBAResult(*(x.clone() for x in graph()))

    run.body, run.graphs = body, graphs
    return run
