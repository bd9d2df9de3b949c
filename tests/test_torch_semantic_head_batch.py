"""PyTorch port, the replicated detector's batched program
(``parallel/semantic_head.detect_block``, ``models/yolo.nms_fixed_batch``)
against ``nms_fixed`` image by image and against the JAX package's
``make_replicated_detector`` (``jax.vmap(detect_one)`` under
``shard_map``), on tests/test_yolo.py's tiny cfg with darknet's random
weights from seed 0 in both packages.

The JAX side splits the batch over a data mesh of the conftest's virtual
CPU devices, the port over as many CPU "devices".  Tolerances: the batched
NMS equal to ``nms_fixed`` of each image bit for bit (the same float32
operations on each element); against JAX those of the detector's parity
tests (XLA's convolutions against PyTorch's, float32): valid masks equal,
boxes within 1e-2 px where valid, scores rtol 1e-4; classes all zero as
in the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.parallel import mesh as JM
from stereo_semantic_vo_tpu.parallel.semantic_head import make_replicated_detector as j_replicated
from stereo_semantic_vo_tpu_torch.models.yolo import nms_fixed, nms_fixed_batch
from stereo_semantic_vo_tpu_torch.parallel import mesh as TM
from stereo_semantic_vo_tpu_torch.parallel.semantic_head import make_replicated_detector
from tests.test_yolo import TINY_CFG
from tests.torch_parity import n, t, one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(conf_threshold=0.3, max_boxes=4, img_hw=(48, 96))


def _nms_batch(case: str, B: int = 5, N: int = 40):
    """(B, N, 4) boxes and (B, N) scores: random, with repeated scores and
    boxes (ties), all scores 0, or every box the same (one pick suppresses
    the rest)."""
    rng = np.random.RandomState({"random": 0, "ties": 1, "zeros": 2, "suppressed": 3}[case])
    xy = rng.uniform(0, 80, (B, N, 2))
    wh = rng.uniform(2, 30, (B, N, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    scores[scores < 0.4] = 0.0
    if case == "ties":
        scores = np.round(scores * 4) / 4  # few distinct values
        boxes[:, N // 2 :] = boxes[:, : N - N // 2]  # each box twice
    elif case == "zeros":
        scores[:] = 0.0
        scores[0, 3] = 0.5  # one image with a single live box
    elif case == "suppressed":
        boxes[:] = boxes[:, :1]
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "suppressed"])
@pytest.mark.parametrize("iou_th", [0.45, 0.0])
def test_batched_nms_equals_nms_fixed_of_each_image(case, iou_th):
    boxes, scores = _nms_batch(case)
    got = nms_fixed_batch(boxes, scores, 16, iou_th)
    for b in range(boxes.shape[0]):
        want = nms_fixed(boxes[b], scores[b], 16, iou_th)
        for name, x, y in zip(("boxes", "scores", "valid"), got, want):
            assert torch.equal(x[b], y), (case, b, name)
    if case == "zeros":
        assert int(got[2].sum()) == 1
    if case == "suppressed":
        assert int(got[2].sum()) == int((scores > 0).any(dim=1).sum())


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).uniform(0, 1, (4, 48, 96, 3)).astype(np.float32)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("B", [2, 4])
def test_batched_block_matches_jax(images, axis, B):
    imgs = images[:B]
    want = j_replicated(JM.make_mesh(axis, axis=JM.DATA_AXIS), TINY_CFG, **KW)(jnp.asarray(imgs))
    detect = make_replicated_detector(TM.make_mesh(axis, axis=TM.DATA_AXIS, device="cpu"), TINY_CFG, **KW)
    got = detect(t(imgs))
    assert tuple(got.boxes.shape) == (B, 4, 4) and tuple(got.valid.shape) == (B, 4)
    v = n(want.valid)
    np.testing.assert_array_equal(n(got.valid), v)
    assert v.any()
    np.testing.assert_allclose(n(got.boxes)[v], n(want.boxes)[v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=1e-4, atol=1e-6)
    assert not n(got.classes).any() and got.classes.dtype == torch.int32
    assert not detect.graphs


def test_capture_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA graphs need CUDA devices"):
        make_replicated_detector(TM.make_mesh(2, axis=TM.DATA_AXIS, device="cpu"), TINY_CFG, capture=True, **KW)
