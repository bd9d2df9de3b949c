"""PyTorch port, the landmark-sharded window BA (``parallel/sharded_ba``,
``engine/window_ba.WindowBA``, ``VOPipeline(ba_mesh=...)``) against the
port's single-device solve and the JAX package's sharded one.

The port's ranks are ``torch.distributed`` processes (gloo on the CPU):
here one in-process rank, and two processes in a worker that imports no
JAX.  Tolerances:
- against the JAX package's ``make_sharded_local_ba`` on a 2-device
  landmark mesh, with stereo edges: tests/test_sharded_ba.py's own, cost
  rtol 1e-3, poses atol 5e-3, median point difference under 0.05 m (LM's
  accept/reject steps amplify differences in reduction order);
- at one rank against the port's ``local_ba``: equal (the all-reduce over
  one rank is the identity, and both use the einsum build on the CPU);
- two gloo processes against a process-local ``local_ba``: poses 1e-4,
  points 1e-3 (the worker's docstring);
- ``WindowBA`` at one rank against ``refine_state``, and
  ``VOPipeline(ba_mesh=...)`` against the pipeline without a mesh on the
  frames of tests/test_pipeline_distributed_ba.py: poses within 1e-3 m
  and 1e-3 rad."""

import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from stereo_semantic_vo_tpu.core import Camera as JCam
from stereo_semantic_vo_tpu.core import CameraConfig, lie
from stereo_semantic_vo_tpu.core.config import BAConfig as JBA
from stereo_semantic_vo_tpu.parallel import mesh as JM
from stereo_semantic_vo_tpu.parallel.sharded_ba import make_sharded_local_ba as j_sharded
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.core.camera import Camera as TCam
from stereo_semantic_vo_tpu_torch.core.config import BAConfig as TBA
from stereo_semantic_vo_tpu_torch.core.config import CameraConfig as TCC
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from stereo_semantic_vo_tpu_torch.engine.window_ba import WindowBA, refine_state
from stereo_semantic_vo_tpu_torch.ops.local_ba import local_ba
from stereo_semantic_vo_tpu_torch.parallel import mesh as TM
from stereo_semantic_vo_tpu_torch.parallel.sharded_ba import make_sharded_local_ba
from tests.test_local_ba import make_ba_problem
from tests.test_tracker import CFG, TX_STEP, empty_boxes, render
from tests.torch_parity import n, rot_angle, t, one_torch_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_sharded_ba_worker.py")
TCFG = interop.config_from_jax(CFG)
TCAM = TCam.from_config(TCC(), "cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo process group in this process, and its mesh."""
    try:
        port = _free_port()
    except OSError:
        pytest.skip("localhost sockets unavailable")
    TM.init_distributed(num_processes=1)  # one process: nothing to do
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    yield TM.make_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def problem():
    """tests/test_sharded_ba.py's problem with stereo observations."""
    F, L = 4, 160
    poses_gt, X_gt, obs, mask = make_ba_problem(jax.random.PRNGKey(10), F=F, L=L, noise_px=0.3)
    key = jax.random.PRNGKey(11)
    dpose = 0.02 * jax.random.normal(key, (F, 6)).at[0].set(0.0)
    poses0 = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dpose, poses_gt)
    X0 = X_gt + 0.15 * jax.random.normal(jax.random.fold_in(key, 1), X_gt.shape)
    cam = JCam.from_config(CameraConfig())
    pc = jnp.einsum("fij,lj->fli", poses_gt[:, :3, :3], X0) + poses_gt[:, None, :3, 3]
    z = jnp.maximum(pc[..., 2], 1e-3)
    obs_ur = obs[..., 0] - cam.bf / z
    obs_rm = mask & (z > 0.5)
    return [np.asarray(a) for a in (poses0, X0, obs, mask, np.ones(L, bool), obs_ur, obs_rm)]


def test_mesh_helpers(mesh):
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {TM.LANDMARK_AXIS: 1})
    x = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(TM.shard_landmarks(mesh, x, dim=1), x)
    assert torch.equal(mesh.all_gather(x), x)
    a, b = mesh.all_reduce([torch.ones(2, 3), torch.full((), 2.0)])
    assert torch.equal(a, torch.ones(2, 3)) and float(b) == 2.0
    data = TM.make_mesh(3, axis=TM.DATA_AXIS, device="cpu")
    assert data.shape == {TM.DATA_AXIS: 3} and len(TM.replicate(data, x)) == 3
    assert TM.make_2d_mesh(2, 1, device="cpu").shape == {TM.DATA_AXIS: 2, TM.LANDMARK_AXIS: 1}
    two = types.SimpleNamespace(size=2, rank=1, device=torch.device("cpu"))  # rank 1 of 2
    assert torch.equal(TM.shard_landmarks(two, x, dim=1), x[:, 3:])
    with pytest.raises(ValueError, match="5 landmarks do not split over 2 ranks"):
        TM.shard_landmarks(two, x[:, :5], dim=1)


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_one_rank_equals_local_ba(mesh, problem, stereo):
    poses0, X0, obs, mask, pv, ur, rm = (t(a) for a in problem)
    cfg = TBA(local_iterations=8)
    edges = {"obs_ur": ur, "obs_r_mask": rm} if stereo else {}
    ref = local_ba(poses0, X0, obs, mask, pv, TCAM, cfg, **edges)
    res = make_sharded_local_ba(mesh, TCAM, cfg, stereo_edges=stereo)(poses0, X0, obs, mask, pv, *edges.values())
    for a, b in zip(res, ref):
        assert torch.equal(a, b)


def test_matches_jax_two_device_mesh_with_stereo_edges(mesh, problem):
    poses0, X0, obs, mask, pv, ur, rm = problem
    want = j_sharded(JM.make_mesh(2), JCam.from_config(CameraConfig()), JBA(local_iterations=8), stereo_edges=True)(
        *(jnp.asarray(a) for a in problem))
    got = make_sharded_local_ba(mesh, TCAM, TBA(local_iterations=8), stereo_edges=True)(*(t(a) for a in problem))
    np.testing.assert_allclose(n(got.cost), n(want.cost), rtol=1e-3)
    np.testing.assert_allclose(n(got.poses), n(want.poses), atol=5e-3)
    assert np.median(np.linalg.norm(n(got.points) - n(want.points), axis=1)) < 0.05


def test_runner_checks_its_stereo_arguments(mesh, problem):
    run = make_sharded_local_ba(mesh, TCAM, TBA(local_iterations=1), stereo_edges=True)
    with pytest.raises(ValueError, match="stereo_edges=True"):
        run(*(t(a) for a in problem[:5]))


def test_two_gloo_processes():
    try:
        port = _free_port()
    except OSError:
        pytest.skip("localhost sockets unavailable")
    coord = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, WORKER, coord, "2", str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers timed out\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "PARITY_OK" in out and "ranks=2" in out, out


def _tracked_state(n_frames=4):
    boxes, bv = (t(a) for a in empty_boxes())
    state = t_init_state(TCFG, "cpu")
    for i in range(n_frames):
        left, right = (t(np.asarray(a)) for a in render(i))
        state, _ = (TT.init_step if i == 0 else TT.track_step)(state, TT.FrameInput(left, right, boxes, bv), TCFG)
    return state


def test_window_ba_one_rank_matches_refine_state(mesh):
    state = _tracked_state()
    wba = WindowBA(TCFG, mesh=mesh)
    assert wba.ready(4) and not wba.ready(3)
    got, stats = wba.refine(state, 4)
    want = refine_state(state, TCFG)
    assert int(stats["n_points"]) >= 8 and int(stats["n_obs"]) > 0
    np.testing.assert_allclose(n(got.win_T_cw), n(want.win_T_cw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got.map_Xw), n(want.map_Xw), rtol=0, atol=1e-5)
    assert torch.equal(got.frame_idx, want.frame_idx) and torch.equal(got.map_uid, want.map_uid)
    # not ready: the state passes through
    early = _tracked_state(2)
    assert wba.refine(early, 2)[0] is early


def _frames(count):
    for i in range(count):
        left, right = (np.asarray(a) for a in render(i))
        yield i, left, right, None, None, i * 0.1


def test_pipeline_with_mesh_matches_no_mesh(mesh):
    """tests/test_pipeline_distributed_ba.py's run: 6 frames, window BA
    every 2nd frame."""
    runs = {}
    for name, m in (("mesh", mesh), ("none", None)):
        pipe = VOPipeline(TCFG, device="cpu", write_trajectory=False, local_ba_every=2, ba_mesh=m)
        pipe.run(_frames(6), prefetch=False)
        runs[name] = np.stack([n(o.T_wc) for o in pipe.outputs]).astype(np.float64)
        assert (pipe.window_ba is not None) == (m is not None)
    a, b = runs["mesh"], runs["none"]
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= 1e-3
    assert max(rot_angle(x[:3, :3].T @ y[:3, :3]) for x, y in zip(a, b)) <= 1e-3
    assert np.linalg.norm(a[-1, :3, 3] - [5 * TX_STEP, 0.0, 0.0]) < 0.08


def test_pipeline_refuses_a_mesh_on_another_device(mesh):
    other = TM.Mesh((torch.device("meta"),), (TM.LANDMARK_AXIS,), mesh.group)
    with pytest.raises(ValueError, match="the mesh's rank runs on meta"):
        VOPipeline(TCFG, device="cpu", local_ba_every=1, ba_mesh=other)
