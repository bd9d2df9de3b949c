"""PyTorch port of the YOLO trainer's device counters against the JAX
package, on the CPU.

``YoloTrainer``'s ``batch_num`` and ``seen`` are 0-d int32 device tensors,
as the JAX ``TrainState``'s are, so that a step captured as a CUDA graph
advances them on every replay: the learning rate is
``device_learning_rate``, a device function of ``batch_num``, and the
region burn-in a device select on ``seen``.  Here, on the CPU:
- ``device_learning_rate`` against JAX's jittable ``learning_rate`` for
  every darknet policy, with and without burn-in, at batch_num 0, 1,
  burn_in - 1, burn_in and either side of a ``steps`` boundary: float32,
  rtol 1e-6;
- ``region_loss`` with ``seen`` as a device tensor equal, bit for bit, to
  ``seen`` as a host int, on either side of 12800;
- three steps of both packages' trainers on the JAX tests' 64x64
  ``TRAIN_CFG`` (batch 4, burn_in 100), both started by ``load_state`` at
  batch_num 98 and seen 12794, so that the steps cross the end of the
  learning-rate burn-in and seen = 12800: loss rtol 1e-4 at each step;
  params, rolling statistics and momentum atol 1e-4 x max|JAX| per leaf
  (tests/test_torch_yolo_train_steps.py's bounds); the counters exact;
- the counters through ``interop`` and back: int32 tensors, numpy int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.models import yolo_train as JT
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.io import darknet as TD
from stereo_semantic_vo_tpu_torch.models import yolo_train as TT
from tests.test_torch_yolo_train import _COLLIDE, CFGS, _close, _images, _nchw, _raw, _truths
from tests.test_yolo_train import TRAIN_CFG
from tests.torch_parity import n, one_torch_thread  # noqa: F401 (autouse fixture)

LR_RTOL = 1e-6
STEP_LOSS_RTOL, STEP_ATOL_REL = 1e-4, 1e-4
BURN_IN = 20
STEPS_AT = 40  # the "steps" policy's first boundary
POLICIES = {
    "steps": {"policy": "steps", "steps": (STEPS_AT, 80), "scales": (0.1, 0.5)},
    "step": {"policy": "step", "step": STEPS_AT, "scale": 0.5},
    "exp": {"policy": "exp", "gamma": 0.99},
    "poly": {"policy": "poly", "max_batches": 200, "power": 4},
    "sig": {"policy": "sig", "gamma": 0.1, "step": STEPS_AT},
    "constant": {"policy": "constant"},
}
START_BATCH, START_SEEN = 98, JT.BURN_IN_SEEN - 6  # TRAIN_CFG's burn_in is 100, its batch 4


@pytest.mark.parametrize("burn_in", [0, BURN_IN])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_device_learning_rate_matches_jax(policy, burn_in):
    net = {"learning_rate": 0.01, "burn_in": burn_in, **POLICIES[policy]}
    for b in (0, 1, BURN_IN - 1, BURN_IN, STEPS_AT - 1, STEPS_AT, STEPS_AT + 1):
        got = TT.device_learning_rate(net, torch.tensor(b, dtype=torch.int32))
        want = np.asarray(JT.learning_rate(net, jnp.asarray(b, jnp.int32)))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(n(got), want, rtol=LR_RTOL, atol=0, err_msg=f"batch_num {b}")


@pytest.mark.parametrize("seen", [0, JT.BURN_IN_SEEN - 1, JT.BURN_IN_SEEN])
def test_region_burn_in_on_a_device_counter_equals_the_host_int(seen):
    cfg = CFGS["region"]
    net = TT.YoloTrainNet(TD.parse_cfg(cfg), _raw(cfg, stats=True))
    (sec, feat), = net(_nchw(_images()))[0]
    t, m = (torch.from_numpy(a) for a in _truths(_COLLIDE, 8))
    a = TT.region_loss(feat, sec, t, m, seen)
    b = TT.region_loss(feat, sec, t, m, torch.tensor(seen, dtype=torch.int32))
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def steps_across_burn_in():
    """Both trainers from the JAX trainer's params at batch_num 98 and
    seen 12794: three steps of 4 images -> (losses, final states)."""
    x = _images()
    t, m = _truths(_COLLIDE, 8)
    jtr = JT.YoloTrainer(TRAIN_CFG, seed=7)
    jtr.state = jtr.state._replace(batch_num=jnp.asarray(START_BATCH, jnp.int32),
                                   seen=jnp.asarray(START_SEEN, jnp.int32))
    st = jtr.state
    ttr = TT.YoloTrainer(TRAIN_CFG, seed=99, device="cpu")
    ttr.load_state(interop.train_state_from_numpy(
        interop.params_to_numpy(st.params), interop.params_to_numpy(st.momentum),
        np.asarray(st.batch_num), np.asarray(st.seen), "cpu"))
    assert (ttr.batch_num, ttr.seen) == (START_BATCH, START_SEEN)
    losses = []
    for s in range(3):
        img = x[::-1].copy() if s % 2 else x
        lj, _ = jtr.train_step(jnp.asarray(img), jnp.asarray(t), jnp.asarray(m))
        lt, _ = ttr.train_step(torch.from_numpy(img), torch.from_numpy(t), torch.from_numpy(m))
        losses.append((lj, lt))
    return losses, jax.tree.map(np.asarray, jtr.state), ttr


@pytest.mark.parametrize("step", [0, 1, 2])
def test_steps_across_burn_in_match_jax_loss(steps_across_burn_in, step):
    lj, lt = steps_across_burn_in[0][step]
    assert lt == pytest.approx(lj, rel=STEP_LOSS_RTOL)


@pytest.mark.parametrize("tree", ["params", "momentum"])
def test_steps_across_burn_in_match_jax_state(steps_across_burn_in, tree):
    _, sj, ttr = steps_across_burn_in
    got = interop.train_state_to_numpy(ttr.state)
    assert (int(got["batch_num"]), int(got["seen"])) == (int(sj.batch_num), int(sj.seen))
    assert (ttr.batch_num, ttr.seen) == (START_BATCH + 3, START_SEEN + 12)
    for li, p in getattr(sj, tree).items():
        for k, v in p.items():
            _close(got[tree][li][k], v, 0, STEP_ATOL_REL, f"{tree} layer {li} {k}")


def test_counters_round_trip_through_interop():
    tr = TT.YoloTrainer(TRAIN_CFG, seed=1, device="cpu")
    state = tr.state
    assert state.batch_num.dtype == state.seen.dtype == torch.int32 and state.seen.shape == ()
    arrays = interop.train_state_to_numpy(state._replace(batch_num=torch.tensor(7, dtype=torch.int32),
                                                         seen=torch.tensor(28, dtype=torch.int32)))
    assert type(arrays["batch_num"]) is np.int32 and type(arrays["seen"]) is np.int32
    back = interop.train_state_from_numpy(arrays["params"], arrays["momentum"], arrays["batch_num"],
                                          arrays["seen"], "cpu")
    assert back.batch_num.dtype == back.seen.dtype == torch.int32
    tr.load_state(back)
    assert (tr.batch_num, tr.seen) == (7, 28)
    again = interop.train_state_to_numpy(tr.state)
    assert (again["batch_num"], again["seen"]) == (np.int32(7), np.int32(28))
