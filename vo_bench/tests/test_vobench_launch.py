"""The wait for the card's fast launch state ends once the probe reads its
first speed again, or at its limit."""

import pytest
import torch

from vo_bench.launch import NODES, LaunchProbe


def probe(readings):
    p = LaunchProbe.__new__(LaunchProbe)
    p.first_ms = 1.04
    it = iter(readings)
    p.read = lambda replays=3: next(it)
    return p


def test_waits_until_the_probe_reads_its_first_speed():
    got = probe([1.22, 1.21, 1.22, 1.05]).wait_fast(10.0, poll_s=0.0)
    assert got["launch_fast"] and got["probe_us"] == pytest.approx(1.05e3 / NODES)
    assert got["probe_first_us"] == pytest.approx(1.04e3 / NODES)


def test_a_fast_start_does_not_wait():
    got = probe([1.06]).wait_fast(10.0, poll_s=0.0)
    assert got["launch_fast"] and got["launch_wait_s"] < 1.0


def test_gives_up_at_its_limit():
    got = probe([1.22] * 1000000).wait_fast(0.05, poll_s=0.001)
    assert not got["launch_fast"] and 0.05 <= got["launch_wait_s"] < 5.0


def test_on_the_card_the_probe_reads_a_speed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = LaunchProbe(torch.device("cuda"))
    assert 0.0 < p.first_ms and p.read() > 0.0
