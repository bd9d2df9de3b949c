"""The plain reference tracks the benchmark's scene, at a small size on the
CPU, to its ground truth, with and without dense stereo and the window
refine."""

import numpy as np
import pytest
import torch

from vo_bench import check
from vo_bench.reference.config import VOConfig as RefConfig
from vo_bench.reference import state as ref_state
from vo_bench.scene import Scene
from vo_bench.tests.small import small

N = 10


@pytest.mark.parametrize("name", ["sparse.stream1", "dense_ba.stream1"])
def test_reference_tracks_the_scene_to_ground_truth(name):
    cell = small(name)
    vo = cell.config["vo_config"]
    cfg = RefConfig.from_dict(vo)
    cam = vo["camera"]
    scene = Scene(cell.traffic["scene"], 2**34 + 9, 0, cam["height"], cam["width"], cam["fps"], 32)
    every = cell.config["pipeline"]["local_ba_every"]
    state, pos_err, rot_err = None, 0.0, 0.0
    for t in range(N):
        refine = every > 0 and t + 1 >= cfg.window.window_frames
        state, T_wc = check.reference_step(cfg, state, scene.frame(t), "init" if t == 0 else "track", refine,
                                           torch.device("cpu"))
        T = T_wc.double().numpy()
        gt = scene.camera_x(t, cam["bf"], cam["fx"])
        pos_err = max(pos_err, float(np.linalg.norm(T[:3, 3] - [gt, 0.0, 0.0])))
        rot_err = max(rot_err, check.rotation_angle(T[:3, :3]))
    assert isinstance(state, ref_state.VOState) and int(state.frame_idx) == N - 1
    assert pos_err <= 0.1 and rot_err <= 0.01, (pos_err, rot_err)
    assert int(state.map_valid.sum()) > 0
