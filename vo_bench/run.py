"""Run one cell of the port's benchmark once on this machine's CUDA card:

    python3 vo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic,
driver, per-layer metrics and limits are found by name from
``BENCHMARK.json`` (``vo_bench/bench.py``).  The program under test is
``stereo_semantic_vo_tpu_torch``; nothing here imports JAX or the JAX
package, and a run that finds either loaded refuses to print a result.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
of the profiled sub-window and the ``breakdown``.  The last lines on
standard error, and the result's last key ``compared``, give each number
that decided ``correct`` beside its limit.  The last line of standard
output is the result.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 3 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_semantic_vo_tpu")


def forbidden_modules() -> list[str]:
    """The top-level names of loaded modules that the benchmark's process
    must not hold, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds (the kernel library itself is built into
    ``stereo_semantic_vo_tpu_torch/build/``)."""
    base = os.path.join(root, ".cache", "vo_bench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from vo_bench.bench import find_cell, measure

    cell = find_cell(args.workload, ROOT)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("vo_bench: no CUDA card: the benchmark measures the port on a card and never on the CPU",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"vo_bench: the cell asks for {chips} cards, this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    res = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    loaded = forbidden_modules()
    if loaded:
        print(f"vo_bench: the process holds {loaded}: the benchmark must not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = res.get("busy_s", 0.0)
        device["window_s"] = res.get("window_s", 0.0)
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line.update({"card": card_line(), "seed": args.seed, "iterations": res["iterations"], "loop": res["loop"],
                 "rate_5s": res["rate_5s"],
                 "setup_s": res["setup_s"], "setup_parts": res["setup_parts"], "samples_checked": res["samples"],
                 "frames_checked": res["sampled"], "check_s": res["check_s"], "read": res["read"],
                 "compared": res["compared"]})
    print(f"vo_bench: {args.workload} seed {args.seed}: {res['iterations']} iterations, setup {res['setup_s']:.3f} s "
          f"{res['setup_parts']}; card {line['card']}", file=sys.stderr)
    for name, c in res["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {str(res['correct']).lower()}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
