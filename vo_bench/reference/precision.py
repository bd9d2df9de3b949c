"""Float32 products for the geometry, or TF32 ones for the control.

``f32_geometry`` runs a function with TF32 off for matmuls and cuDNN, as
the port does.  Inside ``matmul_precision(tf32=True)`` it instead rounds
both float32 operands of every matrix product (``@``, ``matmul``, ``mm``,
``bmm``, ``einsum``) to TF32's 10-bit mantissa before the product, which
then accumulates in float32: the arithmetic of a card's TF32 tensor cores,
on any device.  That is the control of the benchmark's check: the
reference one precision step below the float32 the configuration states.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
from torch.overrides import TorchFunctionMode

_TF32 = contextvars.ContextVar("vo_bench_reference_tf32", default=False)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Run the reference's products in TF32 (``tf32``) or full float32."""
    token = _TF32.set(tf32)
    try:
        yield
    finally:
        _TF32.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away from
    zero), still float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def _tf32_args(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return round_tf32(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_tf32_args(x) for x in a)
    return a


_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, torch.einsum}


class _TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = _tf32_args(args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def f32_matmul():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        if _TF32.get():
            with _TF32Products():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32_geometry(fn):
    """Decorator: run ``fn`` under :func:`f32_matmul`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_matmul():
            return fn(*args, **kwargs)

    return wrapped
