"""One run of one cell: find the cell's files by name, set up the program,
drive the closed loop for the window, read the metrics and check the
output.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``:

* ``vo_bench/configs/<config>.json``: the tracker's configuration
  (``vo_config``, every field of the port's ``VOConfig``), the pipeline's
  options (``pipeline``), its source, and what was reduced or assumed;
  where it has a ``detector`` block, the online detector: its darknet cfg
  file (``cfg_file``, a path from the checkout's root), confidence and NMS
  thresholds, box slots, ``async`` (detection one frame behind the
  tracker) and what shapes the weights that the run makes from its seed
  (``first_frame_candidates``: ``vo_bench/darknet_weights.py``);
* ``vo_bench/traffic/<traffic>.json``: the mix: the driver that runs it,
  the streams, the scene's parameters, warm-up, the sampled frames of the
  check, the profiled iterations and, where given, ``launch_wait_s``, the
  longest wait after set-up for the card's fast launch state
  (``vo_bench/launch.py``);
* ``vo_bench/drivers/<driver>.py``: a ``Driver`` class that sets the
  program up and runs one loop iteration at a time; its ``t`` is the frame
  index that the next iteration hands over;
* ``vo_bench/metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric,
  ``None`` where the run has nothing to read for it;
* ``vo_bench/limits/<cell>.json``: the limit of each number that decides
  ``correct``.

A quantity that cells with different bounds report is split by a suffix:
``frames_per_s.fleet`` is the quantity ``frames_per_s`` (the name up to
its first dot) in the cells it lists, and a per-layer metric that moves it
and ends in the same ``.fleet`` reads with its base's file
(``step.host_ms.fleet`` with ``step.host_ms.py``) unless it has a file of
its own.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from vo_bench import check, stats
from vo_bench.scene import Frames, Scene, rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a traced run reads host spans before this share of the window and then
# profiles the traffic's ``profile_iterations``
PROFILE_FROM = 0.4


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module (file names may hold dots)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    driver: type
    end_to_end: list
    per_layer: list  # [(metric entry, reader module)]


def find_cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    bench = bench or benchmark(root)
    here = os.path.join(root, "vo_bench")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(os.path.join(here, "configs", entry["config"] + ".json"))
    if "detector" in config:
        with open(os.path.join(root, config["detector"]["cfg_file"])) as f:
            config["detector"]["cfg_text"] = f.read()
    traffic = load_json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", name + ".json"))
    driver = load_module(os.path.join(here, "drivers", traffic["driver"] + ".py"),
                         "vo_bench_driver_" + traffic["driver"]).Driver

    def covers(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if covers(m)]
    for m in e2e:
        if quantity(m["name"]) not in END_TO_END:
            raise KeyError(f"end-to-end metric {m['name']!r}: no quantity {quantity(m['name'])!r}")
    layers = [(m, load_module(reader_path(here, m), "vo_bench_metric_" + m["name"]))
              for m in bench["per_layer"] if covers(m)]
    return Cell(name, entry, config, traffic, limits, driver, e2e, layers)


def quantity(name: str) -> str:
    """The quantity an end-to-end metric measures: its name up to the first
    dot (``frames_per_s.fleet`` is ``frames_per_s`` in other cells)."""
    return name.split(".")[0]


def reader_path(here: str, m: dict) -> str:
    """The reader of per-layer metric ``m``: its own file, or, where its
    name ends in the suffix of the end-to-end metric it moves, its base's."""
    own = os.path.join(here, "metrics", m["name"] + ".py")
    suffix = m["moves"][len(quantity(m["moves"])):]
    if os.path.isfile(own) or not suffix or not m["name"].endswith(suffix):
        return own
    return os.path.join(here, "metrics", m["name"][:-len(suffix)] + ".py")


# the quantities an end-to-end metric can measure
END_TO_END = ("frames_per_s", "frame_ms_p95", "setup_s")


def port_config(vo: dict):
    """The port's ``VOConfig`` with the fields of ``vo``."""
    from stereo_semantic_vo_tpu_torch.core import config as port

    kw = {}
    for f in dataclasses.fields(port.VOConfig):
        if f.name not in vo:
            continue
        group = getattr(port, f.type, None) if isinstance(f.type, str) else f.type
        value = vo[f.name]
        kw[f.name] = group(**value) if isinstance(value, dict) else value
    unknown = set(vo) - set(kw)
    if unknown:
        raise KeyError(f"fields the port's VOConfig does not have: {sorted(unknown)}")
    return port.VOConfig(**kw)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float) -> dict:
    """One run: set-up, the window, then the check.  ``t_process`` is the
    host clock at the start of the process.  -> the result's numbers."""
    import torch

    t_measure = time.perf_counter()
    vo, traffic = cell.config["vo_config"], cell.traffic
    cuda = torch.device(device).type == "cuda"
    probe = None
    if cuda and traffic.get("launch_wait_s"):
        from vo_bench.launch import LaunchProbe

        probe = LaunchProbe(torch.device(device))
    cam = vo["camera"]
    scenes = [Scene(traffic["scene"], seed, b, cam["height"], cam["width"], cam["fps"],
                    vo["semantic"]["max_boxes"]) for b in range(traffic["streams"])]
    frames = Frames(scenes)
    t_scenes = time.perf_counter()
    traj_dir = tempfile.mkdtemp(prefix="vo_bench_")
    try:
        det = cell.config.get("detector")
        if det is not None:
            from vo_bench import darknet_weights

            det = dict(det, blob=darknet_weights.blob(det["cfg_text"], seed, det,
                                                      scenes[0].frame(0).left, torch.device(device)))
            if cuda:   # the peak is the program's: the blob's first-frame pass on the card is the harness's
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        bench = SimpleNamespace(vo=vo, pipeline=cell.config["pipeline"], traffic=traffic, seed=seed,
                                device=torch.device(device), frames=frames, port_config=port_config(vo),
                                out_dir=traj_dir, detector=det)
        drv = cell.driver(bench)
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        t_program = time.perf_counter()
        # set-up ends here: the program is built, warmed up and idle.  The
        # launch wait that follows is the harness's own idle pause before the
        # window, not work of the program, and is reported apart
        setup_s = t_program - t_process
        launch = probe.wait_fast(float(traffic["launch_wait_s"])) if probe is not None else {}
        spans = None
        profile = None
        if trace:
            from vo_bench.trace import Profile, Spans

            spans = Spans()
            drv.instrument(spans)
            profile = Profile(int(traffic["profile_iterations"]))
        # the sampled frames of the check: fractions of the window drawn from
        # the seed; sample i waits for a frame at place i of the mover's miss
        # cycle (0: its box missed), so the samples cover the culling path
        due = sorted(rng(seed, 1).uniform(0.05, 0.95, int(traffic["check_samples"])) * seconds)
        taken = 0
        iteration_s, delivered_at = [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds
        profiled_from = None
        n = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            take = (bool(due) and t0 - t_start >= due[0]
                    and scenes[0].miss_phase(drv.t) == taken % scenes[0].miss_every)
            if take:
                due.pop(0)
                taken += 1
            if profile is not None and profiled_from is None and t0 - t_start >= seconds * PROFILE_FROM:
                profile.start()
                spans.annotate = True
                profiled_from = n
            if spans is not None:
                with spans("iteration"):
                    drv.iterate(take)
            else:
                drv.iterate(take)
            t1 = time.perf_counter()
            iteration_s.append(t1 - t0)
            delivered_at.append(t1)
            n += 1
            if profiled_from is not None and spans.annotate and n - profiled_from >= profile.iterations:
                spans.annotate = False
                profile.stop(n - profiled_from)
        if profile is not None and spans.annotate:  # the window closed first
            spans.annotate = False
            profile.stop(n - profiled_from)
        drv.finish()
        peak = int(torch.cuda.max_memory_reserved()) if cuda else 0
        attempted, failed = drv.outcome()
        samples = drv.samples()
        drv.release()
        del drv
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        reference_detector = None
        if det is not None:
            from vo_bench.reference.detector import Detector

            reference_detector = Detector(det["cfg_text"], det["blob"], det["conf_threshold"], det["nms_iou"],
                                          det["max_boxes"], torch.device(device))
        numbers = check.check_samples(samples, lambda b, t: scenes[b].frame(t), vo, torch.device(device),
                                      detector=reference_detector)
        check_s = time.perf_counter() - t_check
        correct, compared = check.judge(numbers, cell.limits)
        result = {"correct": correct, "attempted": attempted, "failed": failed, "setup_s": setup_s,
                  "setup_parts": {"process_to_measure_s": t_measure - t_process, "scenes_s": t_scenes - t_measure,
                                  "program_s": t_program - t_scenes, **launch},
                  "iterations": n,
                  "loop": {**{f"p{q}_ms": float(np.percentile(iteration_s, q)) * 1e3 for q in (50, 90, 95, 99)},
                           "max_ms": max(iteration_s) * 1e3},
                  "rate_5s": stats.rate_bins(delivered_at, t_start, seconds, 5.0, len(scenes)),
                  "memory_peak_bytes": peak, "compared": compared, "samples": len(samples),
                  "read": {k: v for k, v in numbers.items() if k not in compared},
                  "sampled": sorted({s.t for s in samples}), "check_s": check_s}
        if not trace:
            values = {"frames_per_s": stats.frames_per_s(delivered_at, t_start, seconds, len(scenes)),
                      "frame_ms_p95": stats.p95_ms(iteration_s), "setup_s": setup_s}
            result["metrics"] = {m["name"]: {"value": values[quantity(m["name"])], "unit": m["unit"]}
                                 for m in cell.end_to_end}
        else:
            ctx = SimpleNamespace(cell=cell, spans=spans, profile=profile, streams=len(scenes), iterations=n,
                                  vo=vo, pipeline=cell.config["pipeline"])
            metrics = {}
            for m, reader in cell.per_layer:
                value = reader.read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            result["metrics"] = metrics
            if profile is not None and profile.frames:
                from vo_bench import readings

                result["busy_s"], result["window_s"] = readings.busy_and_window(profile)
                result["breakdown"] = readings.breakdown(profile)
        return result
    finally:
        for name in os.listdir(traj_dir):
            os.remove(os.path.join(traj_dir, name))
        os.rmdir(traj_dir)
