"""``run.py`` measures on a card or not at all, and prints the contract's
line there."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vo_bench import bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CMD = [sys.executable, "vo_bench/run.py", "--workload", "sparse.stream1", "--seed", str(2**33 + 5),
       "--seconds", "2", "--trace", "0"]


def test_refuses_to_measure_without_a_card_and_never_falls_back_to_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(CMD, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_refuses_a_cell_that_asks_for_more_cards_than_there_are(monkeypatch, capsys):
    sys.path.insert(0, os.path.join(ROOT, "vo_bench"))
    import run

    from vo_bench import bench

    real = bench.find_cell

    def four(name, root=bench.ROOT, b=None):
        cell = real(name, root, b)
        cell.entry = dict(cell.entry, chips=4)
        return cell

    monkeypatch.setattr(bench, "find_cell", four)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(CMD[2:]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "asks for 4 cards" in out.err


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "vo_bench"))
    import run

    fake = {"stereo_semantic_vo_tpu_torch": object(), "stereo_semantic_vo_tpu_torch.engine": object(),
            "torch": torch}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["jaxlib.xla_client"] = object()
    fake["stereo_semantic_vo_tpu.core"] = object()
    assert run.forbidden_modules() == ["jaxlib", "stereo_semantic_vo_tpu"]


def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in bench.find_cell("sparse.stream1", ROOT).end_to_end}
    assert list(line)[-1] == "compared"
