"""PyTorch port's ``io/native_loader`` and ``io/kitti.iter_frames`` on the CPU.

The loader's cases are tests/test_native_loader.py's on the port's build of
``native/loader.cpp``; they skip, inside a fixture, where g++, libpng or
libjpeg is missing.  ``iter_frames(..., image_hw=...)`` is held to the JAX
package's on both decoders: Pillow (always) and the native loader (where it
builds); decoded frames, boxes and timestamps equal."""

import os

import numpy as np
import pytest

from stereo_semantic_vo_tpu.io import kitti as JK
from stereo_semantic_vo_tpu_torch.io import kitti as TK
from stereo_semantic_vo_tpu_torch.io import native_loader

H, W, N = 48, 64, 6


@pytest.fixture
def native():
    if not native_loader.available():
        pytest.skip(f"native loader not buildable here: {native_loader.why_unavailable()}")
    assert native_loader.why_unavailable() is None


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths_l, paths_r, arrays = [], [], []
    for i in range(N):
        img = rng.randint(0, 256, (H, W), dtype=np.uint8)
        p = str(root / f"l{i}.png")
        Image.fromarray(img).save(p)
        paths_l.append(p)
        arrays.append(img)
        pr = str(root / f"r{i}.png")
        Image.fromarray(rng.randint(0, 256, (H, W), dtype=np.uint8)).save(pr)
        paths_r.append(pr)
    return paths_l, paths_r, arrays


def test_gray_png_exact(native, pngs):
    paths_l, _, arrays = pngs
    np.testing.assert_array_equal(native_loader.decode_gray(paths_l[0], H, W), arrays[0].astype(np.float32))


def test_rgb_png_luma(native, tmp_path):
    from PIL import Image

    rgb = np.zeros((8, 8, 3), np.uint8)
    rgb[..., 0] = 200  # pure red
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(p)
    np.testing.assert_allclose(native_loader.decode_gray(p, 8, 8), np.full((8, 8), 0.299 * 200), atol=0.5)


def test_missing_file_raises(native, tmp_path):
    with pytest.raises(IOError):
        native_loader.decode_gray(str(tmp_path / "none.png"), 8, 8)


def test_prefetcher_in_order_and_exact(native, pngs):
    paths_l, paths_r, arrays = pngs
    got = list(native_loader.NativeFrameLoader(paths_l, paths_r, H, W, depth=2, workers=3))
    assert len(got) == N
    for i, (left, _) in enumerate(got):
        np.testing.assert_array_equal(left, arrays[i].astype(np.float32))


def test_prefetcher_early_close(native, pngs):
    paths_l, paths_r, _ = pngs
    loader = native_loader.NativeFrameLoader(paths_l, paths_r, H, W)
    next(iter(loader))
    loader.close()  # must not hang or crash


def test_build_lands_beside_the_package(native):
    lib = native_loader._build()
    assert os.path.dirname(lib) == native_loader.BUILD_DIR and os.path.basename(lib).startswith("libssvo_loader_")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A KITTI-layout sequence of N stereo PNG pairs, with box files for
    some frames."""
    from PIL import Image

    root = tmp_path_factory.mktemp("seq")
    rng = np.random.RandomState(1)
    for side in ("image_2", "image_3"):
        os.makedirs(root / side)
        for i in range(N):
            Image.fromarray(rng.randint(0, 256, (H, W), dtype=np.uint8)).save(str(root / side / f"{i:06d}.png"))
    np.savetxt(str(root / "times.txt"), np.arange(N) * 0.1)
    boxes = root / "boxes"
    os.makedirs(boxes)
    for i in (1, 3):
        (boxes / f"{i + 1}.txt").write_text("5 20 6 30\n1 2 3 4\n")
    return str(root)


def _frames(mod, seq, use_native, max_frames=None):
    paths = mod.load_sequence_paths(seq)
    return list(mod.iter_frames(paths, os.path.join(seq, "boxes"), 4, max_frames,
                                use_native=use_native, image_hw=(H, W)))


@pytest.mark.parametrize("max_frames", [None, 4])
def test_iter_frames_with_image_hw_pillow_matches_jax(sequence, max_frames):
    got, want = _frames(TK, sequence, False, max_frames), _frames(JK, sequence, False, max_frames)
    assert len(got) == len(want) == (max_frames or N)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[5] == w[5]
        for a, b in zip(g[1:5], w[1:5]):
            np.testing.assert_array_equal(a, b)


def test_iter_frames_native_matches_pillow(native, sequence):
    got, want = _frames(TK, sequence, True), _frames(TK, sequence, False)
    assert [g[0] for g in got] == list(range(N))
    for g, w in zip(got, want):
        for a, b in zip(g[1:5], w[1:5]):
            np.testing.assert_array_equal(a, b)
