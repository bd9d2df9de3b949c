"""PyTorch port, the frame counter on the device against the JAX package.

``VOState.frame_idx`` is a 0-d int32 tensor, as in the reference, and
``init_step`` / ``track_step`` / ``refine_state`` read every use of the
frame index from it: the ring writes land at a device offset, RANSAC draws
under ``fold_in(PRNGKey(seed), t)``, the window order is a device gather and
the refine's gate a device predicate.  Six frames of tests/test_tracker.py's
renderer with VOConfig.kitti()'s knobs (the slice of tests/test_torch_slice.py)
go through both packages with a mid-sequence reseed through ``init_step`` at
frame 3 and the ring wrapping at frames 4 and 5 (W = 4).  Poses within 1e-3 m
and 1e-3 rad (the slice's tolerance: the float sums run in other orders),
frame counters equal, the step's counters within the slice's max(2, 2%)
after frame 0 and exact there; the refine after the wrap within
tests/test_torch_window_ba.py's bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.engine import tracker as JT
from stereo_semantic_vo_tpu.engine import window_ba as JW
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine import window_ba as TW
from stereo_semantic_vo_tpu_torch.engine.graphs import StepGraphs
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from tests.test_torch_slice import COUNTERS, _frame, _kitti_knobs
from tests.test_tracker import TX_STEP
from tests.torch_parity import n, rot_angle, t

N_FRAMES, RESEED_AT = 6, 3


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg_t = _kitti_knobs()
    sj, st = j_init_state(cfg_j), t_init_state(cfg_t, "cpu")
    out_j, out_t, states_j, states_t = [], [], [], []
    for i in range(N_FRAMES):
        left, right, boxes, bv = _frame(i)
        fj = JT.FrameInput(*(jnp.asarray(a) for a in (left, right, boxes, bv)))
        ft = TT.FrameInput(*(t(a) for a in (left, right, boxes, bv)))
        init = i in (0, RESEED_AT)
        sj, oj = (JT.init_step if init else JT.track_step)(sj, fj, cfg_j)
        st, ot = (TT.init_step if init else TT.track_step)(st, ft, cfg_t)
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
        states_j.append({k: np.asarray(v) for k, v in sj._asdict().items()})
        states_t.append(st)
    return cfg_j, cfg_t, out_j, out_t, states_j, states_t


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_device_counter_steps_match_jax(runs, frame):
    _, _, out_j, out_t, states_j, states_t = runs
    fi = states_t[frame].frame_idx
    assert fi.shape == () and fi.dtype == torch.int32
    assert int(fi) == int(states_j[frame]["frame_idx"]) == frame
    Tj, Tt = out_j[frame].T_wc.astype(np.float64), n(out_t[frame].T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3
    assert bool(out_t[frame].pnp_ok) == bool(out_j[frame].pnp_ok)
    assert np.linalg.norm(Tt[:3, 3] - [frame * TX_STEP, 0, 0]) < 0.05
    for name in COUNTERS:
        a, b = int(getattr(out_j[frame], name)), int(getattr(out_t[frame], name))
        tol = 0 if frame == 0 else max(2, int(0.02 * a))
        assert abs(a - b) <= tol, (name, a, b)
    # the ring region written this frame holds the same landmark ids and
    # creation frames in both packages where both created a point
    K = out_t[frame].obs_uid.shape[0]
    region = slice((frame % 4) * K, (frame % 4 + 1) * K)
    both = states_j[frame]["map_valid"][region] & n(states_t[frame].map_valid)[region]
    created = both & (states_j[frame]["map_create_id"][region] == frame)
    assert created.sum() > 0
    np.testing.assert_array_equal(n(states_t[frame].map_uid)[region][created],
                                  states_j[frame]["map_uid"][region][created])
    np.testing.assert_array_equal(n(states_t[frame].map_create_id)[region][created], frame)


def test_reseed_restarts_the_motion_model_and_keeps_the_pose(runs):
    _, _, out_j, out_t, _, states_t = runs
    assert torch.equal(states_t[RESEED_AT].velocity, torch.eye(4))
    assert torch.equal(states_t[RESEED_AT].T_cw, states_t[RESEED_AT - 1].T_cw)
    assert int(out_t[RESEED_AT].n_matches_last) == 0 == int(out_j[RESEED_AT].n_matches_last)


@pytest.mark.parametrize("frame", range(9))
def test_ring_write_at_a_device_offset_equals_the_host_slice(frame):
    K, W = 5, 4
    rng = np.random.RandomState(frame)
    arr = torch.from_numpy(rng.randn(W * K, 3).astype(np.float32))
    src = torch.from_numpy(rng.randn(K, 3).astype(np.float32))
    rows = torch.from_numpy(rng.randn(W, 2).astype(np.float32))
    fi = torch.tensor(frame, dtype=torch.int32)
    want = arr.clone()
    want[(frame % W) * K:(frame % W + 1) * K] = src
    assert torch.equal(TT._set_region(arr, fi, K, W, src), want)
    want_rows = rows.clone()
    want_rows[frame % W] = src[0, :2]
    assert torch.equal(TT._set_row(rows, fi, W, src[0, :2]), want_rows)
    assert torch.equal(TT._region_slots(fi, K, W), torch.arange((frame % W) * K, (frame % W + 1) * K))


@pytest.mark.parametrize("frame", range(3))
def test_refine_state_passes_the_values_through_before_the_window_is_full(runs, frame):
    """The reference keeps the refine's result only under ``lax.cond(can)``;
    the port's device gate keeps every value of the state."""
    _, cfg_t, _, _, _, states_t = runs
    st = states_t[frame]
    got = TW.refine_state(st, cfg_t)
    for name, x in st._asdict().items():
        assert torch.equal(getattr(got, name), x), name


def test_refine_state_after_the_ring_wraps_matches_jax(runs):
    """At frame 5 the window order is ring regions 2, 3, 0, 1."""
    cfg_j, cfg_t, _, _, states_j, _ = runs
    pre = states_j[N_FRAMES - 1]
    want = {k: np.asarray(v) for k, v in JW.refine_state(j_init_state(cfg_j)._replace(
        **{k: jnp.asarray(v) for k, v in pre.items()}), cfg_j)._asdict().items()}
    st = interop.state_from_numpy(pre, "cpu")
    got = TW.refine_state(st, cfg_t)
    for f in range(4):
        Ta, Tb = n(got.win_T_cw[f]).astype(np.float64), want["win_T_cw"][f].astype(np.float64)
        assert np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) <= 1e-3 and rot_angle(Ta[:3, :3].T @ Tb[:3, :3]) <= 1e-3
    np.testing.assert_allclose(n(got.map_Xw), want["map_Xw"], rtol=0, atol=1e-2)
    assert not np.array_equal(n(got.map_Xw), pre["map_Xw"])  # it refined


def test_step_graphs_on_the_cpu_run_the_eager_functions(runs):
    _, cfg_t, _, out_t, _, states_t = runs
    steps = StepGraphs(cfg_t, t_init_state(cfg_t, "cpu"), capture=False)
    steps.frame = TT.FrameInput(*(t(a) for a in _frame(0)))
    out = steps.init()
    assert torch.equal(out.T_wc, out_t[0].T_wc) and torch.equal(steps.state.map_uid, states_t[0].map_uid)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        StepGraphs(cfg_t, t_init_state(cfg_t, "cpu"), capture=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        VOPipeline(cfg_t, device="cpu", capture=True)
    assert not VOPipeline(cfg_t, device="cpu").steps.capture
