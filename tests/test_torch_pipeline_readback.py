"""PyTorch port, ``VOPipeline``'s one-frame-deferred readback on the CPU.

Frame t-1's ``pnp_ok`` and pose are consumed after frame t is dispatched;
on a card they are read from pinned copies after waiting on frame t-1's
event alone, on the CPU from the tensors themselves.  Eight frames of
tests/test_recovery.py's scene (frames 2-4 blank, so PnP fails and the map
is reseeded after 2 lost frames) through the port's pipeline, against:

- the JAX package's ``VOPipeline`` on the same frames with the same
  ``reinit_after_lost``: the same frames reseed, the same ``n_reinits``
  and ``pnp_ok`` at every frame, every pose within 1e-3 m and 1e-3 rad
  (the slice tests' bound: the same threefry draws, float sums in other
  orders);
- a loop of the port's eager init_step / track_step that applies the same
  rule with the readback done in place, as ``_finalize`` did before it
  read pinned copies: the same reseeded frames, the trajectory files byte
  for byte, every output equal."""

import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.engine.pipeline import VOPipeline as JVOPipeline
from stereo_semantic_vo_tpu_torch.engine import tracker as TT
from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline
from stereo_semantic_vo_tpu_torch.engine.state import init_state
from stereo_semantic_vo_tpu_torch.engine.trajectory import TrajectoryWriter
from tests.test_recovery import frames_with_blackout
from tests.test_tracker import CFG
from tests.test_torch_dp_tracker import TCFG
from tests.torch_parity import n, rot_angle, one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES, LOST_AFTER = 8, 2
FILES = ("cameratrajectory_kitti.txt", "cameratrajectory_tum.txt")


def _frames():
    nb = TCFG.semantic.max_boxes
    for _, left, right, _, _, ts in frames_with_blackout(N_FRAMES):
        yield left, right, np.zeros((nb, 4), np.float32), np.zeros(nb, bool), ts


def _drive(pipe) -> list[int]:
    """Every frame through ``pipe``: -> the frames that reseeded."""
    reseeded = []
    for i, f in enumerate(_frames()):
        before = pipe.n_reinits
        pipe.process_frame(*f)
        if pipe.n_reinits > before:
            reseeded.append(i)
    pipe.flush()
    return reseeded


def _reference(out_dir) -> tuple[list, list[int]]:
    """The reseed rule with each readback done in place: -> (outputs, the
    frames that reseeded)."""
    writer = TrajectoryWriter(*(str(out_dir / f) for f in FILES))
    state, outs, reseeded, lost, pending = init_state(TCFG, "cpu"), [], [], 0, None
    for i, (left, right, boxes, valid, ts) in enumerate(_frames()):
        frame = TT.FrameInput(*(torch.from_numpy(np.array(a)) for a in (left, right, boxes, valid)))
        reseed = lost >= LOST_AFTER
        if i == 0 or reseed:
            state, out = TT.init_step(state, frame, TCFG)
            lost = 0
            if reseed:
                reseeded.append(i)
        else:
            state, out = TT.track_step(state, frame, TCFG)
        if pending is not None:  # frame t-1, read after frame t's step
            lost = 0 if bool(pending[0].pnp_ok) else lost + 1
            writer.append(pending[0].T_wc.cpu().numpy(), pending[1])
        pending = (out, ts)
        outs.append(out)
    writer.append(pending[0].T_wc.cpu().numpy(), pending[1])
    writer.close()
    return outs, reseeded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("readback")
    (root / "pipe").mkdir()
    pipe = VOPipeline(TCFG, device="cpu", out_dir=str(root / "pipe"), reinit_after_lost=LOST_AFTER)
    reseeded = _drive(pipe)
    pipe.writer.close()
    jpipe = JVOPipeline(CFG, out_dir=None, write_trajectory=False, reinit_after_lost=LOST_AFTER)
    j_reseeded = _drive(jpipe)
    return root, pipe, reseeded, jpipe, j_reseeded


def test_deferred_readback_reseeds_as_jax(runs):
    _, pipe, reseeded, jpipe, j_reseeded = runs
    assert reseeded == j_reseeded and len(reseeded) >= 1
    assert pipe.n_reinits == jpipe.n_reinits
    assert len(pipe.outputs) == len(jpipe.outputs) == N_FRAMES
    assert [bool(o.pnp_ok) for o in pipe.outputs] == [bool(o.pnp_ok) for o in jpipe.outputs]
    assert bool(pipe.outputs[-1].pnp_ok)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_deferred_readback_poses_match_jax(runs, frame):
    _, pipe, _, jpipe, _ = runs
    Tj = n(jpipe.outputs[frame].T_wc).astype(np.float64)
    Tt = n(pipe.outputs[frame].T_wc).astype(np.float64)
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) <= 1e-3
    assert rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) <= 1e-3


def test_deferred_readback_keeps_the_reseeds_and_trajectory(runs):
    root, pipe, reseeded, _, _ = runs
    (root / "ref").mkdir()
    outs, want = _reference(root / "ref")
    assert reseeded == want and len(want) >= 1
    for f in FILES:
        assert (root / "pipe" / f).read_bytes() == (root / "ref" / f).read_bytes(), f
    assert len(pipe.outputs) == len(outs) == N_FRAMES
    for a, b in zip(pipe.outputs, outs):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
