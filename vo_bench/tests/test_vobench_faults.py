"""The check fails a broken program: a CPU run of the harness (the card's
look skipped, the program eager at a small size) with the timed path
broken underneath comes out with ``correct`` false, once for each fault
that the cells can have.  The cells run on one card, so there is no
exchange between cards to leave out.  The online cell's detector keeps its
352 px input; only the camera shrinks."""

import time

import pytest
import torch

from vo_bench import bench
from vo_bench.scene import Scene
from vo_bench.tests.small import small

SEED = 2**35 + 17
BOX_FAULT_PX = 2.0


SECONDS = {"sparse.stream1": 1.5, "sparse.fleet4": 4.0, "online.stream1": 10.0}


def run(name, seconds=None):
    return bench.measure(small(name), SEED, seconds or SECONDS[name], False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["sparse.stream1", "sparse.fleet4", "online.stream1"])
def test_a_sound_run_is_correct(name):
    res = run(name)
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


def test_a_box_altered_where_it_is_produced(monkeypatch):
    from stereo_semantic_vo_tpu_torch.models import yolo

    real = yolo.YoloDetector.detect

    def nudged(self, img):
        det = real(self, img)
        boxes = det.boxes.clone()
        boxes[0, 0] = boxes[0, 0] + BOX_FAULT_PX   # one coordinate of the best box
        return det._replace(boxes=boxes)

    monkeypatch.setattr(yolo.YoloDetector, "detect", nudged)
    res = run("online.stream1")
    assert not res["correct"], (res["sampled"], res["compared"])
    assert res["compared"]["det_box_gap_px"]["value"] > res["compared"]["det_box_gap_px"]["limit"]


def test_a_head_map_entry_altered_where_it_is_produced(monkeypatch):
    from stereo_semantic_vo_tpu_torch.models import yolo

    real = yolo.YoloNet.forward

    def nudged(self, x):
        (sec, feat), *rest = real(self, x)
        feat = feat.clone()
        feat[0, 4, 5, 5] = feat[0, 4, 5, 5] + 1e-2 * feat.pow(2).mean().sqrt()   # an objectness logit
        return [(sec, feat), *rest]

    monkeypatch.setattr(yolo.YoloNet, "forward", nudged)
    res = run("online.stream1")
    assert not res["correct"], (res["sampled"], res["compared"])
    assert res["compared"]["det_head_gap"]["value"] > res["compared"]["det_head_gap"]["limit"]


def test_the_scene_boxes_in_place_of_the_detections(monkeypatch):
    from stereo_semantic_vo_tpu_torch.engine.pipeline import VOPipeline

    cell = small("online.stream1")
    cam = cell.config["vo_config"]["camera"]
    scene = Scene(cell.traffic["scene"], SEED, 0, cam["height"], cam["width"], cam["fps"],
                  cell.config["vo_config"]["semantic"]["max_boxes"])
    real = VOPipeline._stale_boxes

    def offline(self, frame):
        real(self, frame)   # the detections still run and are waited for
        f = scene.frame(self._n_processed)
        return torch.from_numpy(f.boxes), torch.from_numpy(f.boxes_valid)

    monkeypatch.setattr(VOPipeline, "_stale_boxes", offline)
    res = run("online.stream1")
    assert not res["correct"]
    assert res["compared"]["det_box_gap_px"]["value"] > res["compared"]["det_box_gap_px"]["limit"]
