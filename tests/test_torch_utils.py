"""PyTorch port's ``utils/checkpoint`` and ``utils/profiling``, on the CPU.

Checkpoints: the port's round trip is exact; the schema errors are the JAX
package's; a file written by the JAX package's ``save_state`` loads into the
port (descriptors as int32 bit patterns, the ``*_pm1`` entries skipped,
``frame_idx`` a host int), equal to what it saved; and a pipeline resumed
from a checkpoint tracks bit for bit as the uninterrupted run does, with
and without window BA.  ``device_trace`` writes a Chrome trace under its
directory and does nothing for None (the tracer: test_torch_tracing.py)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu.utils import checkpoint as JC
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import VOState, init_state
from stereo_semantic_vo_tpu_torch.utils import checkpoint as TC
from stereo_semantic_vo_tpu_torch.utils.profiling import device_trace
from tests.test_torch_slice import _frame, _kitti_knobs
from tests.torch_parity import n, one_torch_thread  # noqa: F401

N_FRAMES, N_BEFORE = 5, 2


def _random_state(cfg, seed=0):
    """A port state with every field filled from a seeded draw."""
    rng = np.random.RandomState(seed)
    s = init_state(cfg, "cpu")
    out = {"frame_idx": torch.tensor(6, dtype=torch.int32)}
    for name, v in s._asdict().items():
        if name == "frame_idx":
            continue
        if v.dtype == torch.bool:
            out[name] = torch.from_numpy(rng.rand(*v.shape) < 0.5)
        elif v.dtype == torch.int32:
            out[name] = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, v.shape, dtype=np.int64).astype(np.int32))
        else:
            out[name] = torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
    return VOState(**out)


def test_checkpoint_round_trip(tmp_path):
    _, cfg = _kitti_knobs()
    state = _random_state(cfg)
    p = str(tmp_path / "ckpt.npz")
    TC.save_state(p, state)
    assert os.listdir(tmp_path) == ["ckpt.npz"]  # written through .tmp, then renamed
    back = TC.load_state(p, init_state(cfg, "cpu"))
    assert back.frame_idx.shape == () and back.frame_idx.dtype == torch.int32 and int(back.frame_idx) == 6
    for name in VOState._fields[1:]:
        got, want = getattr(back, name), getattr(state, name)
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want), name
    with np.load(p) as data:  # the JAX package's dtypes on disk
        assert data["map_desc"].dtype == np.uint32 and data["frame_idx"].dtype == np.int32


def _write(path, **arrays):
    with open(path, "wb") as f:
        np.savez(f, **arrays)


@pytest.mark.parametrize("fault", ["schema_v1", "schema_v3", "missing_field"])
def test_checkpoint_refuses_what_the_jax_package_refuses(tmp_path, fault):
    cfg_j, cfg = _kitti_knobs()
    good = interop.state_to_numpy(_random_state(cfg))
    p = str(tmp_path / "bad.npz")
    if fault == "schema_v1":
        _write(p, **{f"arr_{i}": v for i, v in enumerate(good.values())})
        match = "schema-v1"
    elif fault == "schema_v3":
        _write(p, __schema__=np.asarray(3), **good)
        match = "schema v3, expected v2"
    else:
        del good["win_disp"]
        _write(p, __schema__=np.asarray(2), **good)
        match = r"missing VOState fields \[.*'win_disp'\]"
    with pytest.raises(ValueError, match=match):
        TC.load_state(p, init_state(cfg, "cpu"))
    with pytest.raises(ValueError, match=match):  # the reference refuses it too
        JC.load_state(p, j_init_state(cfg_j))


def test_jax_written_checkpoint_loads_into_the_port(tmp_path):
    cfg_j, cfg_t = _kitti_knobs()
    rng = np.random.RandomState(3)
    sj = j_init_state(cfg_j)
    fields = {}
    for name, v in sj._asdict().items():
        a = np.asarray(v)
        if name == "frame_idx":
            fields[name] = jnp.asarray(9, jnp.int32)
        elif a.dtype == np.uint32:
            fields[name] = jnp.asarray(rng.randint(0, 2**32, a.shape, dtype=np.uint64).astype(np.uint32))
        elif a.dtype == np.bool_:
            fields[name] = jnp.asarray(rng.rand(*a.shape) < 0.5)
        elif a.dtype == np.int8:
            fields[name] = jnp.asarray(rng.choice(np.array([-1, 1], np.int8), a.shape))
        elif a.dtype == np.int32:
            fields[name] = jnp.asarray(rng.randint(-1000, 1000, a.shape).astype(np.int32))
        else:
            fields[name] = jnp.asarray(rng.randn(*a.shape).astype(a.dtype))
    sj = type(sj)(**fields)
    p = str(tmp_path / "jax.npz")
    JC.save_state(p, sj)
    back = TC.load_state(p, init_state(cfg_t, "cpu"))
    assert back.frame_idx.shape == () and back.frame_idx.dtype == torch.int32 and int(back.frame_idx) == 9
    for name in VOState._fields[1:]:
        want = np.asarray(fields[name])
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        got = getattr(back, name)
        assert n(got).dtype == want.dtype, name
        np.testing.assert_array_equal(n(got), want, err_msg=name)
    # and the port's checkpoint of it holds the same arrays the JAX one does
    p2 = str(tmp_path / "port.npz")
    TC.save_state(p2, back)
    with np.load(p) as a, np.load(p2) as b:
        assert sorted(b.files) == sorted(k for k in a.files if not k.endswith("_pm1"))
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("local_ba_every", [0, 1])
def test_resumed_pipeline_tracks_bit_for_bit(tmp_path, local_ba_every):
    """Frames 0-4 in one run against frames 0-1, a checkpoint, and frames
    2-4 in a fresh pipeline resumed from it (window BA: refines at frames 3
    and 4 in both)."""
    _, cfg = _kitti_knobs()
    frames = [(i, *_frame(i), 0.1 * i) for i in range(N_FRAMES)]
    whole = VOPipeline(cfg, device="cpu", local_ba_every=local_ba_every)
    whole.run(iter(frames), prefetch=False)

    first = VOPipeline(cfg, device="cpu", local_ba_every=local_ba_every)
    first.run(iter(frames[:N_BEFORE]), prefetch=False)
    p = str(tmp_path / "ckpt.npz")
    TC.save_state(p, first.state)
    second = VOPipeline(cfg, device="cpu", local_ba_every=local_ba_every)
    second.resume(TC.load_state(p, second.state))
    second.run(iter(frames[N_BEFORE:]), prefetch=False)

    outs = first.outputs + second.outputs
    assert len(outs) == len(whole.outputs) == N_FRAMES
    for i, (a, b) in enumerate(zip(whole.outputs, outs)):
        for name in ("T_wc", "n_matches_last", "n_matches_map", "n_pnp_inliers", "obs_uid"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (i, name)
    for name in VOState._fields[1:]:
        assert torch.equal(getattr(whole.state, name), getattr(second.state, name)), name
    assert whole.state.frame_idx == second.state.frame_idx == N_FRAMES - 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with device_trace(d):
        x = torch.arange(1000, dtype=torch.float32)
        (x * 2).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)


def test_device_trace_of_none_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with device_trace(None):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
