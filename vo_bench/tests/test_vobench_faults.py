"""The check fails a broken program: a CPU run of the harness (the card's
look skipped, the program eager at a small size) with the timed path
broken underneath comes out with ``correct`` false, once for each fault
that the cells can have.  The cells run on one card, so there is no
exchange between cards to leave out."""

import time

import pytest
import torch

from vo_bench import bench
from vo_bench.scene import Scene
from vo_bench.tests.small import small

SEED = 2**35 + 17


def run(name, seconds=1.5):
    return bench.measure(small(name), SEED, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["sparse.stream1", "sparse.fleet4"])
def test_a_sound_run_is_correct(name):
    res = run(name, 1.5 if name.endswith("stream1") else 4.0)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["samples"] > 1
    # frame 0, then sample i on a frame at place i of the mover's miss cycle
    scene = Scene(small(name).traffic["scene"], SEED, 0, 120, 320, 10.0, 1)
    sampled = res["sampled"]
    assert sampled[0] == 0 and len(sampled) > 1
    assert [scene.miss_phase(t) for t in sampled[1:]] == [i % scene.miss_every for i in range(len(sampled) - 1)]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from stereo_semantic_vo_tpu_torch.engine import graphs

    real = graphs.track_step
    monkeypatch.setattr(graphs, "track_step", lambda state, frame, cfg: (state, real(state, frame, cfg)[1]))
    res = run("sparse.stream1")
    assert not res["correct"]
    assert res["compared"]["state_mismatch"]["value"] > res["compared"]["state_mismatch"]["limit"]


def test_a_pose_altered_where_it_is_produced(monkeypatch):
    from stereo_semantic_vo_tpu_torch.engine import graphs

    real = graphs.track_step

    def nudged(state, frame, cfg):
        new, out = real(state, frame, cfg)
        T_wc = out.T_wc.clone()
        T_wc[0, 3] += 0.01   # one centimetre
        return new, out._replace(T_wc=T_wc)

    monkeypatch.setattr(graphs, "track_step", nudged)
    res = run("sparse.stream1")
    assert not res["correct"]
    assert res["compared"]["pose_gap_m"]["value"] > res["compared"]["pose_gap_m"]["limit"]


def test_half_of_the_streams_left_out(monkeypatch):
    from stereo_semantic_vo_tpu_torch.engine.state import TrackOutputs
    from stereo_semantic_vo_tpu_torch.engine.tracker import FrameInput
    from stereo_semantic_vo_tpu_torch.parallel import dp_tracker

    real = dp_tracker.make_dp_tracker

    def halved(devices, cfg, capture=None):
        step = real(devices, cfg, capture)

        def half(states, frames):
            h = len(states) // 2
            new, out = step(states[:h], FrameInput(*(x[:h] for x in frames)))
            rest = len(states) - h
            return list(new) + list(states[h:]), TrackOutputs(*(torch.cat([x, x[:rest]]) for x in out))

        half.steps = step.steps
        return half

    monkeypatch.setattr(dp_tracker, "make_dp_tracker", halved)
    res = run("sparse.fleet4")
    assert not res["correct"]
