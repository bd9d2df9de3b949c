"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU, where its Pallas kernels run in interpret mode."""

from __future__ import annotations

import numpy as np
import pytest
import torch


def t(a, device="cpu") -> torch.Tensor:
    """numpy -> torch (uint32 descriptors become int32 bit patterns)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def n(x) -> np.ndarray:
    """torch or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def random_desc(rng: np.random.RandomState, count: int) -> np.ndarray:
    """(count, 8) uint32 random 256-bit descriptors."""
    return rng.randint(0, 2**32, (count, 8), dtype=np.uint64).astype(np.uint32)


def rot_angle(R) -> float:
    """Angle in radians of the rotation matrix ``R``, in float64:
    ``atan2(|vee(R - R^T)| / 2, (tr R - 1) / 2)``.  Unlike
    ``arccos((tr R - 1) / 2)``, whose reading near identity is quantized by
    the rounding of the trace (4.9e-4 rad for one float32 ulp), it resolves
    a small rotation to the rounding of its sine."""
    R = np.asarray(R, np.float64)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(vee) / 2.0, (np.trace(R) - 1.0) / 2.0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module on one intra-op thread, then restore the count.
    Under the suite's parallel workers, torch's default of a thread a core
    in every worker oversubscribes the cores, and a step of many small ops
    waits on its threads: one dp-tracker test took 203 s against 7.4 s on
    an 8-core host with 7 busy processes beside it.  Import it into a test
    module to use it there."""
    count = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(count)
