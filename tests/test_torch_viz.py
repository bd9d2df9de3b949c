"""PyTorch port's ``viz/`` on the CPU: each of the four figures is written
from torch tensors, as the JAX package's tests/test_viz.py writes them from
numpy arrays (matplotlib, headless)."""

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.viz.matches import draw_boxes, draw_matches
from stereo_semantic_vo_tpu_torch.viz.plot import plot_map_points, plot_trajectory, to_numpy


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_trajectory_plot(tmp_path):
    p = np.cumsum(np.random.RandomState(0).uniform(0, 0.5, (30, 3)), axis=0).astype(np.float32)
    out = plot_trajectory(_t(p), _t(p + 0.05), str(tmp_path / "t.png"))
    assert out == str(tmp_path / "t.png") and (tmp_path / "t.png").stat().st_size > 1000


def test_map_plot(tmp_path):
    pts = np.random.RandomState(1).uniform(-5, 5, (100, 3)).astype(np.float32)
    valid = np.random.RandomState(2).rand(100) < 0.7
    plot_map_points(_t(pts), _t(valid), _t(pts[:10]), str(tmp_path / "m.png"))
    assert (tmp_path / "m.png").stat().st_size > 1000


def test_matches_plot(tmp_path):
    img = np.random.RandomState(2).uniform(0, 255, (48, 64)).astype(np.float32)
    uv = np.random.RandomState(3).uniform(5, 40, (20, 2)).astype(np.float32)
    draw_matches(_t(img), _t(img), _t(uv), _t(uv + 2), _t(np.ones(20, bool)), str(tmp_path / "mm.png"))
    assert (tmp_path / "mm.png").stat().st_size > 1000


def test_boxes_plot(tmp_path):
    img = torch.zeros((48, 64))
    boxes = torch.tensor([[5.0, 5.0, 25.0, 25.0], [0.0, 0.0, 1.0, 1.0]])
    uv = torch.tensor([[10.0, 10.0], [40.0, 30.0]])
    draw_boxes(img, boxes, torch.tensor([True, False]), uv=uv, culled=torch.tensor([True, False]),
               out_path=str(tmp_path / "b.png"))
    assert (tmp_path / "b.png").stat().st_size > 1000


def test_to_numpy_takes_tensors_and_arrays():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    np.testing.assert_array_equal(to_numpy(x), np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(to_numpy([[1, 2]]), np.array([[1, 2]]))
