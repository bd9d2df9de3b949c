"""ctypes bindings for the native C++ prefetching frame loader.

Port of ``stereo_semantic_vo_tpu.io.native_loader``.  The library is the
repository's ``native/loader.cpp`` (libpng / libjpeg decode on a thread
pool), built at first use with ``native/Makefile``'s flags into
``build/`` beside this package, named by a hash of the source and flags.
It exposes:

* :func:`decode_gray` — one image -> (H, W) float32 grayscale;
* :class:`NativeFrameLoader` — multithreaded in-order stereo-pair
  prefetcher, the replacement for the reference's per-frame cv::imread
  stall (main.cpp:160-162).

``available()`` is False where g++, libpng or libjpeg is missing, and
``why_unavailable()`` says why; ``io/kitti.iter_frames`` then decodes with
Pillow, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "loader.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]  # native/Makefile
LDLIBS = ["-lpng", "-ljpeg", "-lpthread"]

_lib: ctypes.CDLL | None = None
_why: str | None = None


def _build() -> str:
    """Compile the loader if this source and these flags have no library
    yet; -> its path.  Raises OSError on failure."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("no g++ on PATH")
    with open(SOURCE, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(CXXFLAGS + LDLIBS).encode())
    path = os.path.join(BUILD_DIR, f"libssvo_loader_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", out, SOURCE, *LDLIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            lines = (proc.stderr or proc.stdout).strip().splitlines() or [""]
            first = next((ln for ln in lines if "error" in ln), lines[0])
            raise OSError(f"g++ failed ({proc.returncode}): {first.strip()}")
        os.replace(out, path)  # atomic: a concurrent loader never sees half a file
    return path


def _load() -> ctypes.CDLL | None:
    global _lib, _why
    if _lib is not None or _why is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build())
    except OSError as e:
        _why = str(e)
        return None
    lib.ssvo_decode_gray.restype = ctypes.c_int
    lib.ssvo_decode_gray.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ssvo_loader_create.restype = ctypes.c_void_p
    lib.ssvo_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ssvo_loader_next.restype = ctypes.c_int
    lib.ssvo_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ssvo_loader_destroy.restype = None
    lib.ssvo_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> str | None:
    """Why the library could not be built or loaded (None when it can)."""
    _load()
    return _why


def decode_gray(path: str, H: int, W: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_why}")
    out = np.zeros((H, W), np.float32)
    rc = lib.ssvo_decode_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W
    )
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


class NativeFrameLoader:
    """In-order prefetching iterator over stereo pairs."""

    def __init__(
        self,
        left_paths: list[str],
        right_paths: list[str],
        H: int,
        W: int,
        depth: int = 4,
        workers: int = 2,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_why}")
        self._lib = lib
        self.H, self.W = H, W
        self.n = len(left_paths)
        self._lp = (ctypes.c_char_p * self.n)(*[p.encode() for p in left_paths])
        self._rp = (ctypes.c_char_p * self.n)(*[p.encode() for p in right_paths])
        self._h = lib.ssvo_loader_create(self._lp, self._rp, self.n, depth, H, W, workers)
        if not self._h:
            raise RuntimeError("loader create failed")

    def __iter__(self):
        try:
            while True:
                left = np.empty((self.H, self.W), np.float32)
                right = np.empty((self.H, self.W), np.float32)
                rc = self._lib.ssvo_loader_next(
                    self._h,
                    left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
                if rc == -1:
                    return
                if rc != 0:
                    raise IOError(f"frame decode failed (status {rc})")
                yield left, right
        finally:
            self.close()

    def close(self):
        if self._h:
            self._lib.ssvo_loader_destroy(self._h)
            self._h = None
