"""The control of the check, kept at a size a test run holds: the plain
reference put in the program's place with every float32 product in TF32
(one precision step below the configuration's float32) fails each cell's
limits.  TF32 is emulated by rounding the products' operands, so this runs
on the CPU as on a card."""

import pytest
import torch

from vo_bench import check
from vo_bench.control import control_samples
from vo_bench.reference.precision import round_tf32
from vo_bench.tests.small import small


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, 3.14159265, -2.5e-3, float("inf")])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0**-10 and r[2] == 1.0 + 2.0**-10
    assert abs(float(r[3]) - 3.14159265) <= 3.14159265 * 2.0**-11 and r[5] == float("inf")
    bits = r[:5].view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


@pytest.mark.parametrize("name", ["sparse.stream1", "dense_ba.stream1", "sparse.fleet4", "online.stream1"])
def test_the_control_fails_the_cells_limits(name):
    cell = small(name)
    samples, scenes, detector = control_samples(cell, 2**36 + 1, 11, torch.device("cpu"))
    numbers = check.check_samples(samples, lambda b, t: scenes[b].frame(t), cell.config["vo_config"],
                                  torch.device("cpu"), detector=detector)
    correct, _ = check.judge(numbers, cell.limits)
    assert not correct, numbers
    if detector is not None:   # the TF32 detector alone fails the head maps' limit
        assert numbers["det_head_gap"] > cell.limits["det_head_gap"], numbers
