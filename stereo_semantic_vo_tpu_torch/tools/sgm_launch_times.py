"""Time kernels B1 (patch extraction) and B6 (SGM aggregation) of this tree
against those of another checkout of the port, on one CUDA card, at the
shapes one 1241x376 KITTI frame gives them.

    python3 -m stereo_semantic_vo_tpu_torch.tools.sgm_launch_times --parent DIR

from the root of the repository (it takes the frame's inputs from
``chip_smoke.py``'s helpers).
DIR holds an older ``stereo_semantic_vo_tpu_torch/`` (for example a
``git archive`` of the parent commit, unpacked) whose B6 runs one launch
per direction (``ssvo_sgm_directional``) and whose B1 runs one call per
level.  Both trees' kernels are built from their own sources.  The script
reports, with CUDA events (median of ``--reps`` calls):

- each of the older kernel's four directional launches alone, with and
  without the running sum it adds into (``acc``): the price of the load of
  ``acc`` on the sweep's dependent chain;
- a frame's B6 work (the left and right aggregations, then the refine
  pass) through the older wrapper and through this tree's
  ``sgm_aggregate_batch``, in turns: older, this, this, older;
- this tree's two B6 launches alone (``torch.profiler`` device time);
- a frame's B1 work: the older wrapper's 8 calls, this tree's one
  ``extract_patches_levels`` call, in the same turns.

It checks that both trees' B6 and B1 results are bit-equal.  One JSON line
goes to stdout and, with ``--out PATH``, to that file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.kernels import build, patch_extract, sgm_scan

import stereo_semantic_vo_tpu_torch.kernels as kernels_pkg


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, names: tuple[str, ...], reps: int) -> dict:
    """Device time per call of each kernel whose name holds one of ``names``
    (torch.profiler, CUPTI)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3 / reps
    return out


def load_parent(parent: str):
    """The older tree's ``kernels/build.py``, ``sgm_scan.py`` and
    ``patch_extract.py`` as separate modules bound to the older library."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    kdir = os.path.join(parent, "stereo_semantic_vo_tpu_torch", "kernels")
    pbuild = load("parent_build", os.path.join(kdir, "build.py"))
    saved = kernels_pkg.build
    kernels_pkg.build = pbuild  # the older modules' `from ... import build`
    try:
        psgm = load("parent_sgm_scan", os.path.join(kdir, "sgm_scan.py"))
        ppatch = load("parent_patch_extract", os.path.join(kdir, "patch_extract.py"))
    finally:
        kernels_pkg.build = saved
    return pbuild, psgm, ppatch


def frame_inputs(cfg, dev):
    """A frame's B6 calls (recorded from ``dense_disparity`` by
    ``chip_smoke.frame_aggregations``) and B1 call (random level images at
    the pyramid's shapes, ``extract_orb``'s patch counts, corner origins)."""
    from chip_smoke import frame_aggregations, pyramid_shapes

    calls = frame_aggregations(cfg, dev)
    rng = np.random.RandomState(0)
    r = cfg.orb.patch_size // 2
    P = 2 * r + 1
    levels, ys, xs, counts = [], [], [], []
    for H, W, K in pyramid_shapes(cfg.orb, cfg.camera.height, cfg.camera.width):
        levels.append(torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev))
        y = rng.randint(0, H - P + 1, K).astype(np.int32)
        x = rng.randint(0, W - P + 1, K).astype(np.int32)
        y[:2], x[:2] = [0, H - P], [W - P, 0]
        ys.append(torch.from_numpy(y).to(dev))
        xs.append(torch.from_numpy(x).to(dev))
        counts.append(K)
    return calls, (levels, ys, xs, counts, r)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout holding the older stereo_semantic_vo_tpu_torch/")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sgm_launch_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build.library()
    pbuild, psgm, ppatch = load_parent(args.parent)
    plib = pbuild.library()
    cfg = VOConfig.kitti("00")
    calls, (levels, ys, xs, counts, r) = frame_inputs(cfg, dev)
    reps = args.reps
    res = {"card": card}

    # the older kernel's four launches, each alone, with and without acc
    vols, p1, p2, hs, vs = calls[0]
    vol, ph, pv = vols[0], hs[0], vs[0]
    H, W, D = vol.shape
    out = torch.empty_like(vol)
    stream = torch.cuda.current_stream().cuda_stream
    names = ("h_fwd", "h_bwd", "v_fwd", "v_bwd")
    per_launch = {}
    for i, (horizontal, reverse, plane) in enumerate(((1, 0, ph), (1, 1, ph), (0, 0, pv), (0, 1, pv))):
        for with_acc in (False, True):
            def launch(acc=with_acc, horizontal=horizontal, reverse=reverse, plane=plane):
                plib.call("ssvo_sgm_directional", vol.data_ptr(), plane.data_ptr(),
                          out.data_ptr() if acc else None, out.data_ptr(), H, W, D, horizontal, reverse,
                          float(p1), float(p2), stream)
            per_launch[f"{names[i]}{' +acc' if with_acc else ''}"] = median_ms(launch, reps)
    res["parent_launch_ms"] = per_launch

    # a frame's B6 and B1 work, older and this tree in turns
    def old_sgm():
        return [psgm.sgm_aggregate(v, a, b, h, w) for vols_, a, b, hs_, vs_ in calls
                for v, h, w in zip(vols_, hs_, vs_)]

    def new_sgm():
        return [o for vols_, a, b, hs_, vs_ in calls for o in sgm_scan.sgm_aggregate_batch(vols_, a, b, hs_, vs_)]

    def old_patches():
        return [ppatch.extract_patches(img, y, x, r) for img, y, x in zip(levels, ys, xs)]

    y_all, x_all = torch.cat(ys), torch.cat(xs)

    def new_patches():
        return patch_extract.extract_patches_levels(levels, y_all, x_all, counts, r)

    got, want = new_sgm(), old_sgm()
    torch.cuda.synchronize()
    sgm_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    patches_equal = torch.equal(new_patches(), torch.cat(old_patches()))
    res["bit_equal"] = {"sgm": sgm_equal, "patches": patches_equal}
    turns = {"sgm_parent_ms": [], "sgm_ms": [], "patches_parent_ms": [], "patches_ms": []}
    for order in (("parent", ""), ("", "parent")):
        for who in order:
            suffix = "_parent_ms" if who else "_ms"
            turns["sgm" + suffix].append(median_ms(old_sgm if who else new_sgm, reps))
            turns["patches" + suffix].append(median_ms(old_patches if who else new_patches, 50))
    res["frame"] = turns
    res["device_ms"] = {
        "sgm": device_ms(new_sgm, ("sgm_sweeps_kernel", "sgm_sum_kernel"), reps),
        "sgm_parent": device_ms(old_sgm, ("sgm_directional_kernel",), reps),
        "patches": device_ms(new_patches, ("extract_patches_levels_kernel",), 50),
        "patches_parent": device_ms(old_patches, ("extract_patches_kernel",), 50),
    }
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    if not (sgm_equal and patches_equal):
        raise SystemExit("sgm_launch_times: the two trees' results differ")


if __name__ == "__main__":
    sys.exit(main())
