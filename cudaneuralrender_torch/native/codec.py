"""ctypes bindings for the native runtime library (native/cnr_native.cpp).

The zlib-backed C++ PNG codec and its worker-pool frame writer
(``AsyncFrameWriter``), shared with the JAX package (the C++ source and its
Makefile live in the repo-root ``native/`` directory).
Built with ``make -C native``; auto-builds on first use when a toolchain
is present, and degrades gracefully (callers fall back to PIL) when not.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libcnr_native.so")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def _try_build() -> bool:
    global _build_attempted
    if _build_attempted:
        return os.path.exists(_SO_PATH)
    _build_attempted = True
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        return False
    return os.path.exists(_SO_PATH)


def _stale() -> bool:
    """True when the built library predates the C++ source (a stale .so —
    e.g. restored from a cache — must be rebuilt, or Python and C++
    behavior silently diverge)."""
    src = os.path.join(_NATIVE_DIR, "cnr_native.cpp")
    try:
        return os.path.getmtime(_SO_PATH) < os.path.getmtime(src)
    except OSError:
        return False


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO_PATH) or _stale()) and not _try_build():
            if not os.path.exists(_SO_PATH):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            # wrong-architecture or corrupt binary: degrade to the PIL
            # fallback instead of raising out of available()
            return None
        lib.cnr_encode_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ]
        lib.cnr_encode_png.restype = ctypes.c_int
        lib.cnr_decode_png.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.cnr_decode_png.restype = ctypes.c_int
        lib.cnr_writer_create.argtypes = [ctypes.c_int]
        lib.cnr_writer_create.restype = ctypes.c_void_p
        lib.cnr_writer_enqueue.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ]
        lib.cnr_writer_enqueue.restype = None
        lib.cnr_writer_flush.argtypes = [ctypes.c_void_p]
        lib.cnr_writer_flush.restype = ctypes.c_int
        lib.cnr_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.cnr_writer_destroy.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_u8_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_png(path: str, pixels: np.ndarray, level: int = 6) -> None:
    """Write an [H, W, C] (C in 1/3/4) or [H, W] uint8 array as PNG."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec not built")
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, c = pixels.shape
    rc = lib.cnr_encode_png(path.encode(), _as_u8_ptr(pixels), w, h, c, level)
    if rc != 0:
        raise RuntimeError(f"cnr_encode_png failed (rc={rc}) for {path}")


def decode_png(path: str) -> np.ndarray:
    """Read a PNG as [H, W, 4] uint8 RGBA."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec not built")
    data = np.fromfile(path, np.uint8)
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    rc = lib.cnr_decode_png(_as_u8_ptr(data), data.size, None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"cnr_decode_png failed (rc={rc}) for {path}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.cnr_decode_png(
        _as_u8_ptr(data), data.size, _as_u8_ptr(out), ctypes.byref(w), ctypes.byref(h)
    )
    if rc != 0:
        raise RuntimeError(f"cnr_decode_png failed (rc={rc}) for {path}")
    return out


class AsyncFrameWriter:
    """Worker-pool PNG writer: the render loop enqueues frames (each copied
    on enqueue) and C++ threads encode and write them, so a turntable's
    disk I/O overlaps its rendering."""

    def __init__(self, n_threads: int = 2):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native codec not built")
        self._handle = self._lib.cnr_writer_create(n_threads)

    def enqueue(self, path: str, pixels: np.ndarray) -> None:
        """Queue an [H, W, C] (C in 1/3/4) or [H, W] uint8 frame for ``path``."""
        if not self._handle:
            raise RuntimeError("AsyncFrameWriter is closed")
        pixels = np.ascontiguousarray(pixels, np.uint8)
        if pixels.ndim == 2:
            pixels = pixels[:, :, None]
        h, w, c = pixels.shape
        self._lib.cnr_writer_enqueue(self._handle, path.encode(), _as_u8_ptr(pixels), w, h, c)

    def flush(self) -> int:
        """Block until every queued frame is written; returns the number of
        frames that failed to encode or write."""
        return self._lib.cnr_writer_flush(self._handle) if self._handle else 0

    def close(self) -> None:
        if self._handle:
            self._lib.cnr_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        self.close()
