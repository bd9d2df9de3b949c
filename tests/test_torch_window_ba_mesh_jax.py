"""PyTorch port, the landmark-sharded window refine (``engine/window_ba.
WindowBA`` with a mesh, and ``engine/graphs.StepGraphs`` holding it with
``capture=False``) against the JAX package's ``WindowBA(cfg, mesh=...)`` on
a 2-device landmark mesh of the conftest's virtual CPU devices.

Both refine the same state: four frames of tests/test_tracker.py's
renderer (240x320, K=256, 3 levels, ``VOConfig.kitti()``'s BA knobs, trim
10 px) tracked by the JAX package and carried across with
``interop.state_from_numpy``.  The port's mesh is one in-process gloo
rank.  Tolerances, tests/test_sharded_ba.py's: cost rtol 1e-3, poses atol
5e-3, median landmark difference under 0.05 m (LM's accept/reject steps
amplify differences in reduction order); the stats ``n_obs`` and
``n_points`` equal (the observation build, trim and gate are exact);
``StepGraphs``' eager refine equal, bit for bit, to ``WindowBA.refine``."""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stereo_semantic_vo_tpu.core.config import VOConfig as JVO
from stereo_semantic_vo_tpu.engine import window_ba as JW
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu.parallel import mesh as JM
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine.graphs import StepGraphs
from stereo_semantic_vo_tpu_torch.engine.state import init_state
from stereo_semantic_vo_tpu_torch.engine.window_ba import WindowBA
from stereo_semantic_vo_tpu_torch.parallel import mesh as TM
from stereo_semantic_vo_tpu_torch.parallel.sharded_ba import make_sharded_local_ba
from tests.test_tracker import CFG, empty_boxes, render
from tests.torch_parity import n, one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES = 4
JCFG = dataclasses.replace(CFG, orb=dataclasses.replace(CFG.orb, steer=False), ba=JVO.kitti().ba)
TCFG = interop.config_from_jax(JCFG)


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo process group in this process, and its mesh."""
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    except OSError:
        pytest.skip("localhost sockets unavailable")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    yield TM.make_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def refined():
    """The JAX state after N_FRAMES tracked frames, and JAX's sharded
    refine of it on a 2-device landmark mesh: (state, refined, stats), as
    numpy."""
    boxes, bv = empty_boxes()
    state = j_init_state(JCFG)
    for i in range(N_FRAMES):
        state, _ = (init_step if i == 0 else track_step)(state, FrameInput(*render(i), boxes, bv), JCFG)
    wba = JW.WindowBA(JCFG, mesh=JM.make_mesh(2))
    assert wba.ready(state)
    new, stats = wba.refine(state)
    as_np = lambda s: {k: np.asarray(v) for k, v in s._asdict().items()}  # noqa: E731
    return as_np(state), as_np(new), {k: np.asarray(v) for k, v in stats.items()}


def _check_against_jax(got, stats, want, want_stats):
    assert int(stats["n_obs"]) == int(want_stats["n_obs"]) > 0
    assert int(stats["n_points"]) == int(want_stats["n_points"]) >= 8
    np.testing.assert_allclose(n(stats["cost"]), want_stats["cost"], rtol=1e-3)
    np.testing.assert_allclose(n(got.win_T_cw), want["win_T_cw"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(n(got.T_cw), want["T_cw"], rtol=0, atol=5e-3)
    live = want["map_valid"] & (want["map_uid"] >= 0)
    assert np.median(np.linalg.norm(n(got.map_Xw)[live] - want["map_Xw"][live], axis=1)) < 0.05


def test_window_ba_on_a_mesh_matches_jax(mesh, refined):
    before, want, want_stats = refined
    state = interop.state_from_numpy(before, "cpu")
    got, stats = WindowBA(TCFG, mesh=mesh).refine(state, N_FRAMES)
    _check_against_jax(got, stats, want, want_stats)
    assert not np.array_equal(n(got.map_Xw), before["map_Xw"])
    for name in ("frame_idx", "map_uid", "map_valid", "map_desc", "win_uv"):
        assert torch.equal(getattr(got, name), getattr(state, name)), name


def test_step_graphs_eager_refine_on_a_mesh_matches_window_ba_and_jax(mesh, refined):
    before, want, want_stats = refined
    wba = WindowBA(TCFG, mesh=mesh)
    steps = StepGraphs(TCFG, interop.state_from_numpy(before, "cpu"), capture=False, window_ba=wba)
    T_cw, T_wc = steps.refine()
    ref, stats = wba.refine(interop.state_from_numpy(before, "cpu"), N_FRAMES)
    for name, x, y in zip(ref._fields, ref, steps.state):
        assert torch.equal(x, y), name
    assert torch.equal(T_cw, ref.T_cw) and torch.allclose(T_wc @ T_cw, torch.eye(4), atol=1e-5)
    _check_against_jax(steps.state, stats, want, want_stats)


def test_capture_on_the_cpu_raises(mesh):
    """The sharded runner's graphs and a pipeline's need a card."""
    wba = WindowBA(TCFG, mesh=mesh)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        make_sharded_local_ba(mesh, wba.cam, TCFG.ba, stereo_edges=True, capture=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        StepGraphs(TCFG, init_state(TCFG, "cpu"), capture=True, window_ba=wba)
