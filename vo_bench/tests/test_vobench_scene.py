"""The benchmark's scene: made from the seed, endless, with exact ground truth."""

import numpy as np

from vo_bench.scene import Frames, Scene
from vo_bench.tests.small import small

H, W = 120, 320


def scene(seed=2**40 + 3, stream=0):
    params = small("sparse.stream1").traffic["scene"]
    return Scene(params, seed, stream, H, W, 10.0, 32)


def test_same_seed_same_frames_and_other_seeds_differ():
    a, b, c = scene(), scene(), scene(seed=5)
    for t in (0, 7, 130):
        fa, fb, fc = a.frame(t), b.frame(t), c.frame(t)
        for x, y in zip(fa[1:5], fb[1:5]):
            assert np.array_equal(x, y)
        assert not np.array_equal(fa.left, fc.left)
    assert not np.array_equal(scene(stream=1).frame(0).left, a.frame(0).left)


def test_frames_continue_past_64_and_the_world_repeats_every_period():
    s = scene()
    P = s.period
    for t in (64, 65, P - 1, P, P + 1, 1000):
        f = s.frame(t)
        assert f.left.shape == (H, W) and f.left.dtype == np.float32
        assert np.isfinite(f.left).all() and f.t == t
        g = s.frame(t + P)
        assert np.array_equal(f.left, g.left) and np.array_equal(f.boxes, g.boxes)
    # no column of a frame repeats inside it
    f = s.frame(3)
    assert len({f.left[:, x].tobytes() for x in range(W)}) == W


def test_the_loops_frames_are_the_scenes_frames_made_in_place():
    scenes = [scene(stream=0), scene(stream=1)]
    made = Frames(scenes)
    for t in (0, 5, scenes[0].period + 7):
        got = made.get(t)
        assert [f.left for f in got][0] is made.buffers[0][0]   # no allocation a frame
        for s, f in zip(scenes, got):
            g = s.frame(t)
            assert f.t == g.t == t and f.timestamp == g.timestamp
            assert all(np.array_equal(a, b) for a, b in zip(f[1:5], g[1:5]))


def _background(s, t):
    """Rows of frame t that the mover leaves alone."""
    m = s.p["mover"]
    k, i = divmod(s.place(t), s.pass_frames)
    y = m["y0"] + m["vy_px"] * i
    rows = np.ones(H, bool)
    rows[max(0, y):y + m["size_px"]] = False
    return rows


def test_exact_ground_truth_shifts_and_disparities():
    s = scene()
    p = s.p
    top, bottom = slice(0, H // 2), slice(H // 2, H)
    for t in (0, 63, 64, 500, s.period - 1, 2 * s.period - 1):
        f, g = s.frame(t), s.frame(t + 1)
        keep = _background(s, t) & _background(s, t + 1)
        for rows, d, sh in ((top, p["d_far"], p["shift_far"]), (bottom, p["d_near"], p["shift_near"])):
            r = np.zeros(H, bool)
            r[rows] = True
            r &= keep
            # the right image is the left shifted by the plane's disparity
            assert np.array_equal(f.right[r, : W - d], f.left[r, d:])
            # frame t+1 is frame t shifted by the plane's shift
            assert np.array_equal(g.left[r, : W - sh], f.left[r, sh:])
    assert s.camera_x(10, 386.1448, 718.856) == 10 * 3 * 386.1448 / (24 * 718.856)


def test_mover_wraps_with_a_fresh_texture_and_its_box_is_missed_one_frame_in_five():
    s = scene()
    n = s.pass_frames
    assert not np.array_equal(s.mover_texture(0), s.mover_texture(1))
    m = s.p["mover"]
    f0, fn = s.frame(0), s.frame(n)   # the mover's second pass
    assert f0.boxes[0, 1] == fn.boxes[0, 1] == m["y0"] - m["margin_px"]   # back at the top
    obj = s.mover_texture(1)
    y, x = m["y0"], m["x"]
    assert np.array_equal(fn.left[y:y + m["size_px"], x:x + m["size_px"]], obj)
    assert np.array_equal(fn.right[y:y + m["size_px"], x - p_far(s):x - p_far(s) + m["size_px"]], obj)
    valid = [s.frame(t).boxes_valid[0] for t in range(20)]
    assert valid == [s.place(t) % m["miss_every"] != 0 for t in range(20)]
    assert valid.count(False) == 4
    assert not s.frame(0).boxes_valid[1:].any()


def p_far(s):
    return s.p["d_far"]
