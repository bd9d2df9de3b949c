"""Time kernels B7 (the local-BA block build) and B5 (the motion-only BA
build) of this tree against those of another checkout of the port, on one
CUDA card, at the shapes the dense and knob paths give them.

    python3 -m stereo_semantic_vo_tpu_torch.tools.ba_launch_times --parent DIR

from the root of the repository (it takes its problems from
``chip_smoke.py``'s helpers).  DIR holds an older
``stereo_semantic_vo_tpu_torch/`` (for example a ``git archive`` of the
parent commit, unpacked).  Each tree is imported from its own files and
builds its kernels from its own sources, and each runs a step the way its
own LM loop does: the older tree through its public wrapper, this tree
through the build its loop binds once (``LocalBABuild`` / ``MotionBuild``).
The script reports, with CUDA events (median of ``--reps`` calls), in turns
older, this, this, older:

- B7 per build (F=4, L=2048, stereo row) and B5 per call (K=512);
- one ``local_ba`` (5 LM steps) and one ``motion_only_ba`` (10 LM steps,
  trim 10 px), each with its kernel;

then each tree's B7 and B5 kernels alone on the device (``torch.profiler``).
It checks that the two trees agree: the blocks within the kernels' tolerances of each other, the poses
of both LM loops within 1e-3 (the points' largest differences are
reported beside them).  One JSON line goes to stdout and,
with ``--out PATH``, to that file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import torch

from chip_smoke import (
    BA_ATOL_REL,
    BA_COST_RTOL,
    BA_RTOL,
    MH_ATOL_REL,
    MH_COST_RTOL,
    MH_RTOL,
    device_ms,
    local_ba_problem,
    median_ms,
    motion_problem,
)
from stereo_semantic_vo_tpu_torch.core.camera import Camera
from stereo_semantic_vo_tpu_torch.core.config import VOConfig
from stereo_semantic_vo_tpu_torch.kernels import ba_hessian
from stereo_semantic_vo_tpu_torch.ops import ba as ops_ba
from stereo_semantic_vo_tpu_torch.ops import local_ba as ops_local

PKG = "stereo_semantic_vo_tpu_torch"
POSE_TOL = 1e-3


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items() if k == PKG or k.startswith(PKG + ".")}


def load_parent(parent: str, names: tuple[str, ...] = ("kernels.ba_hessian", "ops.local_ba", "ops.ba")):
    """The older tree's modules ``names`` (by default ``kernels/ba_hessian``,
    ``ops/local_ba`` and ``ops/ba``), imported under the package's own name
    from DIR and then set aside; -> (modules by short name, every module of
    the older package)."""
    ours = _package_modules()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, os.path.abspath(parent))
    try:
        mods = {name: importlib.import_module(f"{PKG}.{name}") for name in names}
        theirs = _package_modules()
    finally:
        sys.path.pop(0)
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(ours)
    return mods, theirs


@contextlib.contextmanager
def imports_from(modules: dict):
    """Resolve the package's imports to ``modules`` while the body runs:
    the older ``motion_only_ba`` imports its kernel module at call time."""
    saved = _package_modules()
    sys.modules.update(modules)
    try:
        yield
    finally:
        sys.modules.update(saved)


def blocks_close(a, b) -> bool:
    ok = all(torch.allclose(x, y, rtol=BA_RTOL, atol=BA_ATOL_REL * max(float(y.abs().max()), 1.0))
             for x, y in zip(a[:5], b[:5]))
    return ok and bool(torch.allclose(a[5], b[5], rtol=BA_COST_RTOL, atol=0.0))


def motion_close(a, b) -> bool:
    ok = all(torch.allclose(x, y, rtol=MH_RTOL, atol=MH_ATOL_REL * float(y.abs().max()))
             for x, y in zip(a[:2], b[:2]))
    return ok and bool(torch.allclose(a[2], b[2], rtol=MH_COST_RTOL, atol=0.0))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout holding the older stereo_semantic_vo_tpu_torch/")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ba_launch_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    old, old_modules = load_parent(args.parent)
    pk, pl, pb = old["kernels.ba_hessian"], old["ops.local_ba"], old["ops.ba"]
    cfg = VOConfig.kitti("00")
    cam = Camera.from_config(cfg.camera, dev)
    reps, delta = args.reps, cfg.ba.huber_delta

    # B7 at the window's shape, and one local_ba on it
    poses, X, obs, mask, ur, rm = local_ba_problem(cfg.camera, dev, cfg.window.window_frames,
                                                   cfg.window.max_map_points)
    L = X.shape[0]
    step = ba_hessian.LocalBABuild(obs, mask, cam, delta, ur, rm)
    X0, valid = X + 0.1, torch.ones(L, dtype=torch.bool, device=dev)
    lcfg = dataclasses.replace(cfg.ba, local_hessian_backend="pallas")
    # B5 at K=512, and one motion_only_ba on it
    T0, Xm, uv, mmask = motion_problem(cfg.camera, dev)
    operands = (Xm.T.contiguous(), uv.T.contiguous(), mmask.to(torch.float32)[None],
                ba_hessian.motion_intrinsics(cam), delta)
    mstep = ba_hessian.MotionBuild(*operands)
    mcfg = dataclasses.replace(cfg.ba, hessian_backend="pallas", trim_px=10.0)

    def old_motion_only_ba():
        with imports_from(old_modules):
            return pb.motion_only_ba(T0, Xm, uv, mmask, cam, mcfg)

    work = {
        "local_ba_blocks": (lambda: pk.local_ba_blocks(poses, X, obs, mask, cam, delta, ur, rm),
                            lambda: step(poses, X)),
        "motion_hessian_gradient": (lambda: pk.motion_hessian_gradient(T0, *operands), lambda: mstep(T0)),
        "local_ba": (lambda: pl.local_ba(poses, X0, obs, mask, valid, cam, lcfg, obs_ur=ur, obs_r_mask=rm),
                     lambda: ops_local.local_ba(poses, X0, obs, mask, valid, cam, lcfg, obs_ur=ur, obs_r_mask=rm)),
        "motion_only_ba": (old_motion_only_ba, lambda: ops_ba.motion_only_ba(T0, Xm, uv, mmask, cam, mcfg)),
    }

    # the two trees agree
    outs = {name: (f_old(), f_new()) for name, (f_old, f_new) in work.items()}
    torch.cuda.synchronize()
    mwant = [x.clone() for x in outs["motion_hessian_gradient"][1]]  # mstep's buffer is overwritten below
    (lb_old, lb_new), (mb_old, mb_new) = outs["local_ba"], outs["motion_only_ba"]
    diff = {"local_ba_poses": float((lb_old.poses - lb_new.poses).abs().max()),
            "local_ba_points": float((lb_old.points - lb_new.points).abs().max()),
            "local_ba_points_rel": float(((lb_old.points - lb_new.points).abs() / lb_old.points.abs().clamp_min(1.0)).max()),
            "motion_only_ba_pose": float((mb_old.T_cw - mb_new.T_cw).abs().max())}
    agree = {
        "local_ba_blocks": blocks_close(*outs["local_ba_blocks"]),
        "motion_hessian_gradient": motion_close(outs["motion_hessian_gradient"][0], mwant),
        "local_ba": diff["local_ba_poses"] <= POSE_TOL,
        "motion_only_ba": diff["motion_only_ba_pose"] <= POSE_TOL,
    }
    res = {"card": card, "agree": agree, "max_diff": diff, "reps": reps}

    turns = {f"{name}{suffix}": [] for name in work for suffix in ("_parent_ms", "_ms")}
    for order in (("parent", "this"), ("this", "parent")):
        for who in order:
            for name, (f_old, f_new) in work.items():
                n = reps if name in ("local_ba_blocks", "motion_hessian_gradient") else max(reps // 5, 5)
                turns[name + ("_parent_ms" if who == "parent" else "_ms")].append(
                    median_ms(f_old if who == "parent" else f_new, reps=n, warmup=3))
    res["turns"] = turns
    res["device_ms"] = {
        "local_ba_blocks_parent": device_ms(work["local_ba_blocks"][0],
                                            ("local_ba_blocks_kernel", "local_ba_finalize_kernel"), reps),
        "local_ba_blocks": device_ms(work["local_ba_blocks"][1], ("local_ba_blocks_kernel",), reps, only=True),
        "motion_hessian_gradient_parent": device_ms(work["motion_hessian_gradient"][0],
                                                    ("motion_hessian_kernel",), reps),
        "motion_hessian_gradient": device_ms(work["motion_hessian_gradient"][1], ("motion_hessian_kernel",), reps,
                                             only=True),
    }

    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    if not all(agree.values()):
        raise SystemExit("ba_launch_times: the builds disagree")


if __name__ == "__main__":
    sys.exit(main())
