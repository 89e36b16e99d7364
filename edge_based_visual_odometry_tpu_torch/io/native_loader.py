"""ctypes bindings for the native C++ prefetching stereo-frame loader.

Copy of `edge_based_visual_odometry_tpu/io/native_loader.py`. Builds
io/native/loader.cpp on first use (g++, libpng) into `build/native_loader/`
at the repository root and exposes a Python iterator. Falls back cleanly
when the toolchain or libpng is unavailable - callers should use
`native_available()` to decide.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native_loader")
_SO = os.path.join(_BUILD_DIR, "libebvo_loader.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        # loader.cpp may be absent in a source-stripped install: use the
        # prebuilt .so rather than raising from getmtime
        src = os.path.join(_DIR, "loader.cpp")
        if os.path.exists(_SO) and (
                not os.path.exists(src)
                or os.path.getmtime(_SO) >= os.path.getmtime(src)):
            return ctypes.CDLL(_SO)
    except OSError:
        pass
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _SO,
             os.path.join(_DIR, "loader.cpp"), "-lpng", "-lz", "-lpthread"],
            check=True, capture_output=True, timeout=120)
        return ctypes.CDLL(_SO)
    except Exception:
        _build_failed = True
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.ebvo_loader_create.restype = ctypes.c_void_p
                lib.ebvo_loader_create.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int]
                lib.ebvo_loader_next.restype = ctypes.c_int
                lib.ebvo_loader_next.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float)]
                lib.ebvo_loader_destroy.argtypes = [ctypes.c_void_p]
                lib.ebvo_decode_gray.restype = ctypes.c_int
                lib.ebvo_decode_gray.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int, ctypes.c_int]
                _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


class PrefetchLoader:
    """Iterate (frame_idx, left, right) float32 (H, W) arrays with
    background decode threads (see loader.cpp docstring)."""

    def __init__(self, pairs: List[Tuple[str, str]], height: int, width: int,
                 prefetch_depth: int = 4, n_threads: int = 2):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._h, self._w = height, width
        self._n = len(pairs)
        self._consumed = 0
        self.skipped = 0          # decode failures (bad file OR dims != rig)
        lefts = (ctypes.c_char_p * self._n)(
            *[p[0].encode() for p in pairs])
        rights = (ctypes.c_char_p * self._n)(
            *[p[1].encode() for p in pairs])
        self._handle = lib.ebvo_loader_create(
            lefts, rights, self._n, height, width, prefetch_depth, n_threads)

    def __iter__(self):
        return self

    def __next__(self):
        while self._consumed < self._n:
            left = np.empty((self._h, self._w), np.float32)
            right = np.empty((self._h, self._w), np.float32)
            idx = self._lib.ebvo_loader_next(
                self._handle,
                left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            self._consumed += 1
            if idx == -1:
                break
            if idx == -2:
                # decode failure: warn + skip (reference print-and-continue,
                # Stereo_Iterator.cpp:74). loader.cpp also returns -2 when
                # the decoded dimensions differ from the rig resolution.
                self.skipped += 1
                if self.skipped <= 3:
                    import sys
                    print(f"warning: native decode failed for pair "
                          f"{self._consumed - 1} (bad file or image dims != "
                          f"rig resolution {self._h}x{self._w}); skipping",
                          file=sys.stderr)
                continue
            return idx, left, right
        raise StopIteration

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.ebvo_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_gray(path: str, height: int, width: int) -> Optional[np.ndarray]:
    """One-shot native grayscale decode; None on failure."""
    lib = _get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), np.float32)
    rc = lib.ebvo_decode_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width)
    return out if rc == 0 else None
