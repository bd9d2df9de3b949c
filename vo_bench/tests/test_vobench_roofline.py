"""The frozen byte and operation counts of the hand-written kernels, held
to the bounds of the port's kernel table at the KITTI shapes (1241x376,
K=512, D=48, a 4-frame window of 2048 landmarks; popcounts on 132 SMs at
1,980 MHz)."""

import json
import os

import pytest

from vo_bench import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def vo(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["vo_config"]


def test_bounds_at_the_kitti_shapes():
    sparse, dense = vo("kitti00_sparse"), vo("kitti00_dense_ba")
    H, W = 376, 1241
    us = 1e6
    assert roofline.patches_s(sparse["orb"], H, W) * us == pytest.approx(2.7, rel=0.05)       # B1
    assert roofline.keypoint_stereo_s(sparse["stereo"], 512, H, W) * us == pytest.approx(0.233, rel=0.03)  # B2
    assert roofline.matcher_s(512, 2048, roofline.popc_per_s()) * us == pytest.approx(2.5, rel=0.01)  # B3
    assert roofline.sgm_s(dense["stereo"], H, W) * us == pytest.approx(164, rel=0.01)       # B6
    assert roofline.local_ba_blocks_s(4, 2048, 1) * us == pytest.approx(0.247, rel=0.01)    # B7


def test_each_path_counts_the_kernels_it_runs():
    rate = roofline.popc_per_s()
    sp = roofline.frame_bounds(vo("kitti00_sparse"), 0, rate)
    de = roofline.frame_bounds(vo("kitti00_dense_ba"), 1, rate)
    assert set(sp) == {"patches", "keypoint_stereo", "matcher"}
    assert set(de) == {"patches", "matcher", "sgm", "local_ba_blocks"}
    # five block builds a refine, a refine every frame
    assert de["local_ba_blocks"] == pytest.approx(5 * roofline.local_ba_blocks_s(4, 2048, 1))
    assert roofline.expected_covered(10, 10, 2, 2, 0) == 0.0
    assert roofline.expected_covered(10, 10, 10, 10, 3) == 100.0
