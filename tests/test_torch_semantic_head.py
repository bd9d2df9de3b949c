"""PyTorch port, the replicated detector (``parallel/semantic_head``)
against the JAX package's, on tests/test_yolo.py's tiny cfg with darknet's
random weights from seed 0 in both packages.

The JAX side splits the batch over a 2-device data mesh of the conftest's
virtual CPU devices, the port over two CPU "devices".  Tolerances, those
of the detector's parity tests (XLA's convolutions against PyTorch's,
float32): valid masks equal, boxes within 1e-2 px where valid, scores rtol
1e-4; classes all zero as in the reference.  Against ``YoloDetector.detect`` of each
frame alone the port's batch is equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.io import darknet as JD
from stereo_semantic_vo_tpu.parallel import mesh as JM
from stereo_semantic_vo_tpu.parallel.semantic_head import make_replicated_detector as j_replicated
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.models.yolo import YoloDetector
from stereo_semantic_vo_tpu_torch.parallel import mesh as TM
from stereo_semantic_vo_tpu_torch.parallel.semantic_head import make_replicated_detector
from tests.test_yolo import TINY_CFG
from tests.torch_parity import n, t, one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(conf_threshold=0.3, max_boxes=4, img_hw=(48, 96))


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).uniform(0, 1, (4, 48, 96, 3)).astype(np.float32)


def test_replicated_detector_matches_jax(images):
    want = j_replicated(JM.make_mesh(2, axis=JM.DATA_AXIS), TINY_CFG, **KW)(jnp.asarray(images))
    got = make_replicated_detector(TM.make_mesh(2, axis=TM.DATA_AXIS, device="cpu"), TINY_CFG, **KW)(t(images))
    assert tuple(got.boxes.shape) == (4, 4, 4) and tuple(got.valid.shape) == (4, 4)
    v = n(want.valid)
    np.testing.assert_array_equal(n(got.valid), v)
    assert v.any()
    np.testing.assert_allclose(n(got.boxes)[v], n(want.boxes)[v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=1e-4, atol=1e-6)
    assert not n(got.classes).any()


def test_replicated_batch_equals_each_frame_alone(images):
    detect = make_replicated_detector(TM.make_mesh(2, axis=TM.DATA_AXIS, device="cpu"), TINY_CFG, **KW)
    # the JAX package's random params carried across (interop.params_to_numpy)
    params = interop.params_to_numpy(JD.random_weights(JD.parse_cfg(TINY_CFG)))
    one = YoloDetector.from_params(TINY_CFG, params, KW["conf_threshold"], max_boxes=KW["max_boxes"], device="cpu")
    out = detect(t(images))
    for b, img in enumerate(images):
        d = one.detect(t(img))
        for name in ("boxes", "scores", "valid"):
            assert torch.equal(getattr(out, name)[b], getattr(d, name)), (b, name)


def test_batch_must_split_over_the_devices(images):
    detect = make_replicated_detector(TM.make_mesh(2, axis=TM.DATA_AXIS, device="cpu"), TINY_CFG, **KW)
    with pytest.raises(ValueError, match="expected"):
        detect(t(images[:3]))
