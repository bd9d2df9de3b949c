"""Semi-global scanline aggregation over an (H, W, D) cost volume.

Port of ``stereo_semantic_vo_tpu.kernels.sgm_scan.sgm_aggregate_pallas``
with the contract of ``ops/dense_stereo.sgm_aggregate``'s plain body: four
directional sweeps (left to right, right to left, top to bottom, bottom to
top) summed as ``((h_fwd + h_bwd) + v_fwd) + v_bwd``.  The kernel is
``csrc/sgm_scan.cu``: one launch runs every sweep of up to four volumes at
once (a frame's left and right volumes share one), a second sums them.
Each step of the recurrence is

    out = (c + min(prev, min(prev) + P2, prev[d-1] + P1, prev[d+1] + P1)) - min(prev)

with the ends of the disparity axis refilled by the 1e9 sentinel.  It has
only min, add and subtract, the kernel keeps this order with round-to-nearest
intrinsics, and the sweeps accumulate in the plain version's order, so the
kernel and ``sgm_aggregate_plain`` agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_semantic_vo_tpu_torch.kernels import build

_BIG = 1e9  # the reference's boundary sentinel
MAX_D = 64  # the kernel holds a scanline's D costs in two registers per lane
MAX_BATCH = 4  # volumes one launch takes


def sgm_pass(
    vol: torch.Tensor, p1: float, p2: float, axis: int, reverse: bool,
    p2x: torch.Tensor | None = None,
) -> torch.Tensor:
    """One directional SGM sweep along ``axis`` (0: down the rows, 1: along
    the columns) of an (H, W, D) volume; the reverse sweep walks backward
    from the far end's raw cost.  ``p2x`` (H, W), if given, replaces the
    scalar P2 per position (the current position's value)."""
    moved = vol.movedim(axis, 0)  # (S, X, D)
    S, X, _ = moved.shape
    p2m = None if p2x is None else p2x.movedim(axis, 0)
    big = torch.full((X, 1), _BIG, dtype=vol.dtype, device=vol.device)
    out = torch.empty_like(moved)
    prev = None
    for s in range(S - 1, -1, -1) if reverse else range(S):
        c = moved[s]
        if prev is None:
            prev = c
        else:
            prev_min = torch.amin(prev, dim=-1, keepdim=True)
            shift_m = torch.cat([big, prev[:, :-1]], dim=1)
            shift_p = torch.cat([prev[:, 1:], big], dim=1)
            pen2 = prev_min + (p2 if p2m is None else p2m[s][:, None])
            best = torch.minimum(torch.minimum(prev, pen2), torch.minimum(shift_m + p1, shift_p + p1))
            prev = c + best - prev_min
        out[s] = prev
    return out.movedim(0, axis)


def sgm_aggregate_plain(vol, p1: float, p2: float, p2x_h=None, p2x_v=None) -> torch.Tensor:
    acc = sgm_pass(vol, p1, p2, 1, False, p2x_h)
    acc = acc + sgm_pass(vol, p1, p2, 1, True, p2x_h)
    acc = acc + sgm_pass(vol, p1, p2, 0, False, p2x_v)
    return acc + sgm_pass(vol, p1, p2, 0, True, p2x_v)


def _per_volume(planes, n: int, name: str) -> list:
    if planes is None:
        return [None] * n
    if len(planes) != n:
        raise ValueError(f"{name}: expected {n} planes (or None entries), got {len(planes)}")
    return list(planes)


def sgm_aggregate_batch_plain(vols, p1: float, p2: float, p2x_h=None, p2x_v=None) -> list[torch.Tensor]:
    hs, vs = _per_volume(p2x_h, len(vols), "p2x_h"), _per_volume(p2x_v, len(vols), "p2x_v")
    return [sgm_aggregate_plain(v, p1, p2, h, w) for v, h, w in zip(vols, hs, vs)]


def sgm_aggregate_batch(vols, p1: float, p2: float, p2x_h=None, p2x_v=None) -> list[torch.Tensor]:
    """4-path SGM of up to 4 same-shape (H, W, D) float32 volumes at once,
    penalties already scaled and shared; ``p2x_h`` / ``p2x_v``, if given,
    list one (H, W) per-position P2 plane (or None) per volume for the
    horizontal and vertical sweeps.  -> one (H, W, D) sum per volume.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    twice (all sweeps of all volumes, then their sums)."""
    vols = list(vols)
    if not 1 <= len(vols) <= MAX_BATCH:
        raise ValueError(f"the SGM kernel takes 1-{MAX_BATCH} volumes, got {len(vols)}")
    hs, vs = _per_volume(p2x_h, len(vols), "p2x_h"), _per_volume(p2x_v, len(vols), "p2x_v")
    if vols[0].device.type == "cpu":
        return sgm_aggregate_batch_plain(vols, p1, p2, hs, vs)
    dev = vols[0].device
    H, W, D = vols[0].shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"the SGM kernel takes 1 <= D <= {MAX_D}, got D={D}")
    if H * W * D >= 2**31:
        raise ValueError(f"the SGM kernel indexes a volume with 32-bit offsets, got {H}x{W}x{D}")
    n = len(vols)
    ptrs = [(ctypes.c_void_p * n)() for _ in range(3)]
    for i, (vol, h, v) in enumerate(zip(vols, hs, vs)):
        build.check_cuda(vol, f"vols[{i}]", torch.float32, (H, W, D))
        for name, plane in ((f"p2x_h[{i}]", h), (f"p2x_v[{i}]", v)):
            if plane is not None:
                build.check_cuda(plane, name, torch.float32, (H, W))
        if any(x is not None and x.device != dev for x in (vol, h, v)):
            raise ValueError("all tensors must be on one device")
        for k, x in enumerate((vol, h, v)):
            ptrs[k][i] = None if x is None else x.data_ptr()
    lib = build.library()
    scratch = torch.empty((n, 4, H, W, D), dtype=torch.float32, device=dev)  # one plane a sweep
    out = torch.empty((n, H, W, D), dtype=torch.float32, device=dev)
    args = (*ptrs, n, H, W, D, float(p1), float(p2), scratch.data_ptr(), out.data_ptr(),
            build.stream_handle(vols[0]))
    if dev.index == torch.cuda.current_device():
        lib.call("ssvo_sgm_aggregate", *args)
    else:
        with torch.cuda.device(dev):
            lib.call("ssvo_sgm_aggregate", *args)
    sgm_aggregate_batch.launches += 2
    return list(out.unbind(0))


sgm_aggregate_batch.launches = 0


def sgm_aggregate(vol, p1: float, p2: float, p2x_h=None, p2x_v=None) -> torch.Tensor:
    """4-path SGM of one (H, W, D) float32 volume, penalties already scaled;
    ``p2x_h`` / ``p2x_v`` (H, W) are the optional per-position P2 planes of
    the horizontal and vertical sweeps.  The one-volume case of
    ``sgm_aggregate_batch``, whose launch count it adds to."""
    return sgm_aggregate_batch([vol], p1, p2, [p2x_h], [p2x_v])[0]
