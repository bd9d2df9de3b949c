"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(Hopper), all started together, and the objects are linked into one shared
library with a plain C interface.  The sources include no PyTorch headers,
so a build takes seconds.  The library lands in ``build/`` beside this
package, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.

Each C entry point takes device pointers and sizes plus the CUDA stream, as
Python ints, launches on that stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: (pointers..., sizes..., stream) -> cudaError_t as int
SIGNATURES = {
    "ssvo_extract_patches_levels": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P],
    "ssvo_keypoint_stereo_costs": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "ssvo_keypoint_disparity": [
        _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P, _P,
    ],
    "ssvo_fused_best_match": [_P, _P, _P, _P, _I, _I, _P, _P],
    "ssvo_sgm_aggregate": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P],
    "ssvo_local_ba_blocks": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P],
    "ssvo_fast_scores_levels": [_P, _P, _P, _I, _I, _F, _F, _I, _I, _P, _P],
    "ssvo_motion_hessian_gradient": [_P, _P, _P, _P, _P, _I, _F, _P, _P],
    "ssvo_hamming_distance_matrix": [_P, _P, _I, _I, _P, _P],
    "ssvo_stamp": [_P, _P, _I, _I, _I, _I, _P],
    "ssvo_dense_cost_volumes": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P],
}


class KernelLibrary:
    """The loaded library, its build log and how long the build took."""

    def __init__(self, path: str, log: str, build_seconds: float):
        self.path = path
        self.log = log
        self.build_seconds = build_seconds
        self._dll = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        rc = getattr(self._dll, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")

    def function(self, name: str):
        """The C entry point ``name``, looked up once, for a wrapper that
        launches it in a loop: it returns the ``cudaError_t``, which the
        caller checks."""
        return getattr(self._dll, name)


_library: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _library
    if _library is not None:
        return _library
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libssvo_kernels_{h.hexdigest()[:16]}.so")
    log, seconds = "", 0.0
    if not os.path.exists(path):
        t0 = time.perf_counter()
        log = _compile_and_link(sources, path)
        seconds = time.perf_counter() - t0
    _library = KernelLibrary(path, log, seconds)
    return _library


def _compile_and_link(sources: list[str], path: str) -> str:
    """One nvcc per source, all at once, then one link; -> the compilers'
    output (ptxas registers, shared memory and spills per kernel)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)
        ]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        failed = [s for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(lib, path)  # atomic: a concurrent loader never sees half a file
    return log


def stream_handle(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int: the raw
    handle, read as Triton's launcher reads it, since
    ``torch.cuda.current_stream`` builds a Stream object at every call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_tensors(index: int, checks) -> None:
    """Raise unless each ``(name, tensor, dtype, shape)`` of ``checks`` is a
    contiguous tensor of that dtype and shape on CUDA device ``index``.
    Attribute reads only: the wrapper's host time is most of a small
    kernel's call."""
    for name, x, dtype, shape in checks:
        if x.dtype != dtype or x.shape != shape or not x.is_contiguous() or x.get_device() != index:
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {tuple(shape)} on cuda:{index}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if index < 0:
        raise ValueError("expected CUDA tensors, got CPU tensors")


def call_on(index: int, name: str, *args) -> None:
    """Call the C entry point ``name`` with CUDA device ``index`` current,
    entering its context only when another device is current."""
    import torch

    lib = library()
    if index == torch.cuda.current_device():
        lib.call(name, *args)
    else:
        with torch.cuda.device(index):
            lib.call(name, *args)


def check_cuda(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
