"""BENCHMARK.json keeps to the benchmark's contract, every entry resolves to
files by name, and a new cell comes in through new files alone."""

import json
import os
import re
import shutil
import time

import pytest

from vo_bench import bench, check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load():
    return bench.benchmark(ROOT)


def test_the_file_keeps_to_the_contract():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "vo_bench/run.py"] and b["paths"] == ["vo_bench"]
    assert isinstance(b["run_seconds"], int) and b["run_seconds"] >= 1
    assert len(json.dumps(b)) < 64 * 1024
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vo_bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    cells = [w["name"] for w in b["workloads"]]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["config"] for w in b["workloads"]} == set(names)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert {"frames_per_s", "frame_ms_p95", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        # every cell that reads the metric reports the end-to-end metric it moves
        assert m["moves"] in e2e and set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    every = names + cells + list(e2e) + [m["name"] for m in b["per_layer"]]
    for n in every + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(set(cells)) == len(cells) and len(set(names)) == len(names)
    for cell in cells:   # every cell reports setup_s, another end-to-end metric and a per-layer metric
        assert sum(1 for m in b["end_to_end"] if cell in m.get("workloads", cells)) >= 2
        assert sum(1 for m in b["per_layer"] if cell in m.get("workloads", cells)) >= 1


@pytest.mark.parametrize("cell", [w["name"] for w in load()["workloads"]])
def test_every_cell_resolves_to_its_files_by_name(cell):
    c = bench.find_cell(cell, ROOT)
    assert c.config["name"] == c.entry["config"]
    assert os.path.isfile(os.path.join(ROOT, "vo_bench", "drivers", c.traffic["driver"] + ".py"))
    assert all(callable(getattr(c.driver, f, None)) for f in
               ("setup", "instrument", "iterate", "finish", "outcome", "samples", "release"))
    assert c.limits and set(c.limits) <= set(check.READ)
    assert all(hasattr(mod, "read") for _, mod in c.per_layer)
    assert all(bench.quantity(m["name"]) in bench.END_TO_END for m in c.end_to_end)
    bench.port_config(c.config["vo_config"])   # every field is one of the port's


DUMMY_DRIVER = '''
from vo_bench.check import Sample


class Driver:
    def __init__(self, bench):
        self.b, self.t = bench, 0

    def setup(self):
        pass

    def instrument(self, spans):
        pass

    def iterate(self, sample):
        self.b.frames.get(self.t)
        self.t += 1

    def finish(self):
        pass

    def outcome(self):
        return self.t, 0

    def samples(self):
        return []

    def release(self):
        pass
'''


def test_a_new_cell_comes_in_through_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "vo_bench"), root / "vo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: (root / p).read_bytes() for p in ("vo_bench/bench.py", "vo_bench/run.py")}
    b = json.loads((root / "BENCHMARK.json").read_text())
    # the new files: a traffic mix naming a new driver, the driver, a metric, the limits
    t = json.loads((root / "vo_bench/traffic/stream1.json").read_text())
    t["driver"] = "idle"
    (root / "vo_bench/traffic/idle1.json").write_text(json.dumps(t))
    (root / "vo_bench/drivers/idle.py").write_text(DUMMY_DRIVER)
    (root / "vo_bench/metrics/idle.count.py").write_text("def read(ctx):\n    return ctx.iterations\n")
    (root / "vo_bench/limits/sparse.idle1.json").write_text(
        json.dumps({"pose_gap_m": 0, "rot_gap_rad": 0, "map_gap_m": 0, "state_mismatch": 0}))
    b["workloads"].append({"name": "sparse.idle1", "config": "kitti00_sparse", "traffic": "idle1", "chips": 1,
                           "why": "a dummy"})
    b["per_layer"].append({"name": "idle.count", "unit": "n", "better": "higher", "source": "program_counter",
                           "layer": "Driver", "moves": "frames_per_s", "workloads": ["sparse.idle1"]})
    for m in b["end_to_end"]:   # the new cell reports the one-stream rate and tail
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
            m["workloads"].append("sparse.idle1")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.find_cell("sparse.idle1", str(root))
    assert [m["name"] for m, _ in cell.per_layer] == ["idle.count"]
    cell.config["vo_config"]["camera"].update(width=320, height=120)
    cell.traffic["scene"]["period_frames"] = 128
    cell.traffic["scene"]["mover"].update(size_px=40, x=150, y0=4)
    res = bench.measure(cell, 11, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] and res["attempted"] == res["iterations"] > 0
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert all((root / p).read_bytes() == v for p, v in before.items())


def test_a_split_quantity_reads_with_its_base_files():
    b = load()
    cell = bench.find_cell("sparse.fleet4", ROOT, b)
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s.fleet", "frame_ms_p95.fleet", "setup_s"}
    readers = {m["name"]: mod.__file__ for m, mod in cell.per_layer}
    assert readers["step.host_ms.fleet"].endswith(os.path.join("metrics", "step.host_ms.py"))
    assert readers["dp.self_ms"].endswith(os.path.join("metrics", "dp.self_ms.py"))
    bad = json.loads(json.dumps(b))
    bad["end_to_end"].append({"name": "frames_per_hour", "unit": "n", "better": "higher", "bound": 0.1,
                              "source": "host_clock"})
    with pytest.raises(KeyError, match="frames_per_hour"):
        bench.find_cell("sparse.fleet4", ROOT, bad)


def test_a_second_online_cell_comes_in_through_new_files_alone(tmp_path):
    """Another darknet detector (route, shortcut, upsample, two yolo heads)
    beside the tracker: a config file, its cfg and a limits file, with their
    entries in BENCHMARK.json; the harness's code and the reference are
    untouched, and the check reads the detector's numbers."""
    from vo_bench.tests.test_vobench_detector import TWO_HEADS_CFG

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "vo_bench"), root / "vo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    code = {str(p.relative_to(root)): p.read_bytes() for p in (root / "vo_bench").rglob("*.py")}
    (root / "vo_bench/configs/tiny3_online.cfg").write_text(TWO_HEADS_CFG)
    config = json.loads((root / "vo_bench/configs/kitti00_online.json").read_text())
    config["name"] = "tiny3_online"
    config["detector"].update(cfg_file="vo_bench/configs/tiny3_online.cfg", conf_threshold=0.6)
    (root / "vo_bench/configs/tiny3_online.json").write_text(json.dumps(config))
    shutil.copy(root / "vo_bench/limits/online.stream1.json", root / "vo_bench/limits/tiny3.stream1.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny3_online", "source": "https://arxiv.org/abs/1804.02767",
                         "file": "vo_bench/configs/tiny3_online.json", "reduced": [], "why": "a second detector"})
    b["workloads"].append({"name": "tiny3.stream1", "config": "tiny3_online", "traffic": "stream1", "chips": 1,
                           "why": "a second online cell"})
    next(m for m in b["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append("tiny3.stream1")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.find_cell("tiny3.stream1", str(root))
    assert cell.config["detector"]["cfg_text"] == TWO_HEADS_CFG
    vo = cell.config["vo_config"]
    vo["camera"].update(width=320, height=120, cx=160.0, cy=60.0)
    vo["orb"].update(max_keypoints=128, n_levels=3, grid_rows=2, grid_cols=4)
    cell.traffic["scene"]["period_frames"] = 128
    cell.traffic["scene"]["mover"].update(size_px=40, x=150, y0=4, vy_px=8)
    res = bench.measure(cell, 2**34 + 3, 3.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["compared"]
    assert {"det_head_gap", "det_box_gap_px"} <= set(res["compared"]) and res["samples"] > 1
    assert {str(p.relative_to(root)): p.read_bytes() for p in (root / "vo_bench").rglob("*.py")} == code
