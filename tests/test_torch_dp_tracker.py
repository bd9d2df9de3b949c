"""PyTorch port, the data-parallel tracker (``parallel/dp_tracker``)
against the JAX package's, and against single-stream runs.

The JAX side runs ``make_dp_tracker`` on a 2-device data mesh of the
conftest's virtual CPU devices; the port runs its streams round-robin over
two CPU "devices".  Stream 1 starts one step late (its state reset to a
fresh one, ``frame_idx == -1``), so the two streams run init_step and
track_step side by side.  Tolerances: poses within 1e-3 m and 1e-3 rad of
the JAX streams (the same threefry draws, float sums in other orders);
every stream equal, bit for bit, to its own single-stream
init_step / track_step run (the same ops on the same inputs); the states
carried across with ``interop.states_from_numpy`` exact."""

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
from stereo_semantic_vo_tpu_torch.parallel import mesh as TM
from tests.test_tracker import CFG, TX_STEP, empty_boxes, render
from tests.torch_parity import n, rot_angle, t, one_torch_thread  # noqa: F401 (autouse fixture)

TCFG = interop.config_from_jax(CFG)
N_STEPS = 4
LATE = 1  # stream 1 starts at this step


def _frames(ts):
    """The batched frames of one step: stream b sees rendered frame ts[b]."""
    boxes, bv = (np.asarray(a) for a in empty_boxes())
    imgs = [tuple(np.asarray(a) for a in render(i)) for i in ts]
    return (np.stack([a for a, _ in imgs]), np.stack([b for _, b in imgs]),
            np.stack([boxes] * len(ts)), np.stack([bv] * len(ts)))


@pytest.fixture(scope="module")
def runs():
    mesh = JM.make_mesh(2, axis=JM.DATA_AXIS)
    jstep = JDP.make_dp_tracker(mesh, CFG)
    tstep = TDP.make_dp_tracker(TM.make_mesh(2, axis=TM.DATA_AXIS, device="cpu"), TCFG)
    sj = JDP.batched_init_state(CFG, 2)
    st = TDP.batched_init_state(TCFG, 2, ["cpu", "cpu"])
    out_j, out_t = [], []
    for step in range(N_STEPS):
        if step == LATE:  # stream 1 (re)starts here
            fresh = j_init_state(CFG)
            sj = jax.tree.map(lambda a, b: a.at[1].set(b), sj, fresh)
            st[1] = t_init_state(TCFG, "cpu")
        fr = _frames([step, step])
        sj, oj = jstep(sj, JFrame(*(jnp.asarray(a) for a in fr)))
        st, ot = tstep(st, TT.FrameInput(*(t(a) for a in fr)))
        out_j.append(jax.tree.map(np.asarray, oj))
        out_t.append(ot)
    return out_j, out_t, sj, st


@pytest.mark.parametrize("stream", [0, 1])
def test_streams_match_jax(runs, stream):
    out_j, out_t, sj, st = runs
    assert int(st[stream].frame_idx) == int(np.asarray(sj.frame_idx)[stream]) == N_STEPS - 1 - (LATE if stream else 0)
    start = LATE if stream else 0
    for step in range(start, N_STEPS):
        Tj = out_j[step].T_wc[stream].astype(np.float64)
        Tt = n(out_t[step].T_wc[stream]).astype(np.float64)
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3, step
        assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3, step
        assert bool(out_t[step].pnp_ok[stream]) == bool(out_j[step].pnp_ok[stream])
        # the stream's own motion since its first frame
        assert np.linalg.norm(Tt[:3, 3] - [(step - start) * TX_STEP, 0, 0]) < 0.05


def test_streams_equal_single_stream_runs():
    """Three streams over two devices, starting at steps 0, 1 and 2 on
    offset frames: each equals its own init_step / track_step run."""
    B, steps = 3, 4
    devs = TM.make_mesh(2, axis=TM.DATA_AXIS, device="cpu")
    step_fn = TDP.make_dp_tracker(devs, TCFG)
    states = TDP.batched_init_state(TCFG, B, devs)
    singles = [None] * B
    outs = []
    for s in range(steps):
        for b in range(B):
            if s == b:  # stream b starts at step b
                states[b] = t_init_state(TCFG, "cpu")
                singles[b] = (t_init_state(TCFG, "cpu"), [])
        states, out = step_fn(states, TT.FrameInput(*(t(a) for a in _frames([s + b for b in range(B)]))))
        outs.append(out)
        for b in range(B):
            if singles[b] is None:
                continue
            st, seq = singles[b]
            fr = TT.FrameInput(*(t(a)[b] for a in _frames([s + i for i in range(B)])))
            st, o = (TT.init_step if int(st.frame_idx) < 0 else TT.track_step)(st, fr, TCFG)
            singles[b] = (st, seq + [(s, o)])
    for b in range(B):
        state, seq = singles[b]
        for s, o in seq:
            for name, x in zip(o._fields, o):
                assert torch.equal(getattr(outs[s], name)[b], x), (b, s, name)
        for name, x in state._asdict().items():
            y = getattr(states[b], name)
            assert torch.equal(x, y), (b, name)


def test_batched_states_cross_between_the_packages(runs):
    _, _, sj, st = runs
    arrays = {k: np.asarray(v) for k, v in sj._asdict().items()}
    back = interop.states_from_numpy(arrays, ["cpu"])
    assert [int(s.frame_idx) for s in back] == [int(i) for i in arrays["frame_idx"]]
    again = interop.states_to_numpy(back)
    for k, v in again.items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    ours = interop.states_to_numpy(st)
    np.testing.assert_array_equal(ours["frame_idx"], arrays["frame_idx"])
    np.testing.assert_array_equal(ours["map_uid"], arrays["map_uid"])


def test_step_checks_the_batch():
    step = TDP.make_dp_tracker(["cpu"], TCFG)
    states = TDP.batched_init_state(TCFG, 2, ["cpu"])
    with pytest.raises(ValueError, match="2 states and 3 frames"):
        step(states, TT.FrameInput(*(t(a) for a in _frames([0, 1, 2]))))
