"""PyTorch port, the data-parallel tracker's restarts (eager,
``capture=False``) against single-stream runs and the JAX package's
``make_dp_tracker``.

Two streams on the CPU over four steps; stream b sees rendered frame
s + b at step s.  Stream 1 restarts at step 1 from a fresh
``init_state``; stream 0 restarts at step 3 from its own state after step
1, saved through ``interop.state_to_numpy`` and loaded back with
``state_from_numpy`` (a checkpoint the tracker did not hand out, so it
reads its frame counter once), and tracks frame 3 against the map of
frame 1.  The JAX side runs the same restarts on a 2-device data mesh of
the conftest's virtual CPU devices.  Tolerances: every output of every
step and the final states equal, bit for bit, each stream's own
init_step / track_step run from the same states; poses within 1e-3 m and
1e-3 rad of the JAX streams (the same threefry draws, float sums in other
orders), ``pnp_ok`` and the frame counters equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu.engine.tracker import FrameInput as JFrame
from stereo_semantic_vo_tpu.parallel import dp_tracker as JDP
from stereo_semantic_vo_tpu.parallel import mesh as JM
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from stereo_semantic_vo_tpu_torch.parallel import dp_tracker as TDP
from tests.test_torch_dp_tracker import TCFG, _frames
from tests.test_tracker import CFG
from tests.torch_parity import n, rot_angle, t, one_torch_thread  # noqa: F401 (autouse fixture)

B, N_STEPS = 2, 4
FRESH_AT = 1             # stream 1 restarts from a fresh state here
SAVE_AT, LOAD_AT = 1, 3  # stream 0's state after step 1 is loaded back at step 3


@pytest.fixture(scope="module")
def runs():
    jstep = JDP.make_dp_tracker(JM.make_mesh(2, axis=JM.DATA_AXIS), CFG)
    tstep = TDP.make_dp_tracker(["cpu"], TCFG, capture=False)
    sj = JDP.batched_init_state(CFG, B)
    st = TDP.batched_init_state(TCFG, B, ["cpu"])
    singles = [(t_init_state(TCFG, "cpu"), []), None]
    out_j, out_t, saved_j, saved_t = [], [], None, None
    for s in range(N_STEPS):
        fr = _frames([s + b for b in range(B)])
        if s == FRESH_AT:
            sj = jax.tree.map(lambda a, b: a.at[1].set(b), sj, j_init_state(CFG))
            st[1] = t_init_state(TCFG, "cpu")
            singles[1] = (t_init_state(TCFG, "cpu"), [])
        if s == LOAD_AT:
            sj = jax.tree.map(lambda a, b: a.at[0].set(jnp.asarray(b)), sj, saved_j)
            st[0] = interop.state_from_numpy(saved_t, "cpu")
            singles[0] = (interop.state_from_numpy(saved_t, "cpu"), singles[0][1])
        sj, oj = jstep(sj, JFrame(*(jnp.asarray(a) for a in fr)))
        st, ot = tstep(st, TT.FrameInput(*(t(a) for a in fr)))
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
        for b in range(B):
            if singles[b] is not None:
                state, seq = singles[b]
                run = TT.init_step if int(state.frame_idx) < 0 else TT.track_step
                state, o = run(state, TT.FrameInput(*(t(a)[b] for a in fr)), TCFG)
                singles[b] = (state, seq + [(s, o)])
        if s == SAVE_AT:
            saved_j = jax.tree.map(lambda a: np.asarray(a)[0], sj)
            saved_t = interop.state_to_numpy(st[0])
    return out_j, out_t, sj, st, singles


@pytest.mark.parametrize("stream", [0, 1])
def test_restarted_streams_equal_single_stream_runs(runs, stream):
    _, out_t, _, st, singles = runs
    state, seq = singles[stream]
    assert [s for s, _ in seq] == list(range(FRESH_AT if stream else 0, N_STEPS))
    for s, o in seq:
        for name, x in zip(o._fields, o):
            assert torch.equal(getattr(out_t[s], name)[stream], x), (s, name)
    for name, x in state._asdict().items():
        assert torch.equal(getattr(st[stream], name), x), name


@pytest.mark.parametrize("stream", [0, 1])
def test_restarted_streams_match_jax(runs, stream):
    out_j, out_t, sj, st, _ = runs
    assert int(st[stream].frame_idx) == int(np.asarray(sj.frame_idx)[stream])
    for s in range(FRESH_AT if stream else 0, N_STEPS):
        Tj = out_j[s].T_wc[stream].astype(np.float64)
        Tt = n(out_t[s].T_wc[stream]).astype(np.float64)
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3, s
        assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3, s
        assert bool(out_t[s].pnp_ok[stream]) == bool(out_j[s].pnp_ok[stream]), s
    assert all(bool(out_t[s].pnp_ok[stream]) for s in range(FRESH_AT + 1 if stream else 1, N_STEPS))


def test_a_loaded_state_rewinds_the_frame_counter(runs):
    _, _, _, st, _ = runs
    # stream 0: init 0, track 1, 2, then from frame 1's state tracks 3 as its frame 2
    assert int(st[0].frame_idx) == SAVE_AT + N_STEPS - LOAD_AT
    assert int(st[1].frame_idx) == N_STEPS - 1 - FRESH_AT


def test_graphs_on_the_cpu_raise():
    with pytest.raises(ValueError, match="CUDA"):
        TDP.make_dp_tracker(["cpu"], TCFG, capture=True)
