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
    assert roofline.cost_volumes_s(dense["stereo"], H, W) * us == pytest.approx(54.6, rel=0.001)  # 179 MB + 3.7 MB
    assert roofline.sgm_s(dense["stereo"], H, W) * us == pytest.approx(164, rel=0.01)       # B6
    assert roofline.local_ba_blocks_s(4, 2048, 1) * us == pytest.approx(0.247, rel=0.01)    # B7


def test_each_path_counts_the_kernels_it_runs():
    rate = roofline.popc_per_s()
    sp = roofline.frame_bounds(vo("kitti00_sparse"), 0, rate)
    de = roofline.frame_bounds(vo("kitti00_dense_ba"), 1, rate)
    assert set(sp) == {"patches", "keypoint_stereo", "matcher"}
    assert set(de) == {"patches", "matcher", "cost_volumes", "sgm", "local_ba_blocks"}
    # five block builds a refine, a refine every frame
    assert de["local_ba_blocks"] == pytest.approx(5 * roofline.local_ba_blocks_s(4, 2048, 1))
    # the online cell runs the sparse path: its detector is no hand-written kernel
    assert roofline.frame_bounds(vo("kitti00_online"), 0, rate) == sp
    assert roofline.expected_covered(10, 10, 2, 2, 0) == 0.0
    assert roofline.expected_covered(10, 10, 10, 10, 3) == 100.0


def test_detector_flops_count_the_cfgs_convolutions():
    with open(os.path.join(HERE, "configs", "kitti00_online.cfg")) as f:
        cfg = f.read()
    # 3x3 convolutions at 352, 176, 88, 44, 22, 11 px (16 ... 512 filters), 1024 and 512 at 11 px, the 1x1 head
    by_hand = (2 * 16 * 27 * 352**2 + sum(2 * (16 << k) * (8 << k) * 9 * (176 >> (k - 1)) ** 2 for k in range(1, 6))
               + 2 * 1024 * 512 * 9 * 121 + 2 * 512 * 1024 * 9 * 121 + 2 * 30 * 512 * 121)
    assert roofline.detector_flops(cfg) == by_hand
    assert roofline.detector_flops(cfg) / 1e9 == pytest.approx(3.82, abs=0.005)
