"""Semi-global scanline aggregation over an (H, W, D) cost volume.

Port of ``stereo_semantic_vo_tpu.kernels.sgm_scan.sgm_aggregate_pallas``
with the contract of ``ops/dense_stereo.sgm_aggregate``'s plain body: four
directional sweeps (left to right, right to left, top to bottom, bottom to
top) summed as ``((h_fwd + h_bwd) + v_fwd) + v_bwd``.  The kernel is
``csrc/sgm_scan.cu``, one launch per direction, the later three adding
into the output.  Each step of the recurrence is

    out = (c + min(prev, min(prev) + P2, prev[d-1] + P1, prev[d+1] + P1)) - min(prev)

with the ends of the disparity axis refilled by the 1e9 sentinel.  It has
only min, add and subtract, the kernel keeps this order with round-to-nearest
intrinsics, and the sweeps accumulate in the plain version's order, so the
kernel and ``sgm_aggregate_plain`` agree bit for bit.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.kernels import build

_BIG = 1e9  # the reference's boundary sentinel
MAX_D = 64  # the kernel holds a scanline's D costs in two registers per lane


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


def sgm_aggregate(vol, p1: float, p2: float, p2x_h=None, p2x_v=None) -> torch.Tensor:
    """4-path SGM of an (H, W, D) float32 volume, penalties already scaled;
    ``p2x_h`` / ``p2x_v`` (H, W) are the optional per-position P2 planes of
    the horizontal and vertical sweeps.

    CPU tensors take the plain version; CUDA tensors launch the kernel four
    times (one per direction)."""
    if vol.device.type == "cpu":
        return sgm_aggregate_plain(vol, p1, p2, p2x_h, p2x_v)
    H, W, D = vol.shape
    build.check_cuda(vol, "vol", torch.float32, (H, W, D))
    for name, plane in (("p2x_h", p2x_h), ("p2x_v", p2x_v)):
        if plane is not None:
            build.check_cuda(plane, name, torch.float32, (H, W))
            if plane.device != vol.device:
                raise ValueError("all tensors must be on one device")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"the SGM kernel takes 1 <= D <= {MAX_D}, got D={D}")
    lib = build.library()
    out = torch.empty_like(vol)
    stream = build.stream_handle(vol)
    sweeps = ((1, 0, p2x_h), (1, 1, p2x_h), (0, 0, p2x_v), (0, 1, p2x_v))
    with torch.cuda.device(vol.device):
        for i, (horizontal, reverse, plane) in enumerate(sweeps):
            lib.call(
                "ssvo_sgm_directional",
                vol.data_ptr(), None if plane is None else plane.data_ptr(),
                None if i == 0 else out.data_ptr(), out.data_ptr(),
                H, W, D, horizontal, reverse, float(p1), float(p2), stream,
            )
            sgm_aggregate.launches += 1
    return out


sgm_aggregate.launches = 0
