"""ctypes bindings for the native (C++) PNG decoder of the data path
(counterpart: ``diff3d_tpu/native/__init__.py``, an own copy).

``decoder.cpp`` is compiled on first use with the system ``g++`` (and
libpng) into ``build/native/libd3dnative-<hash of the source>.so`` at the
repo root, not next to the source.  If the toolchain or libpng is missing,
:func:`available` is False, :func:`build_error` says why, and the callers
(``data/srn.py``) take the PIL path; :func:`available` is how a caller
tells which path ran.

Public surface:
  * :func:`available` -- native runtime usable?
  * :func:`decode_image` -- one PNG -> ``[s, s, 3] float32`` in [-1, 1].
  * :class:`DecoderPool` -- persistent C++ worker pool decoding whole
    batches GIL-free; :func:`shared_pool` is the process-wide one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_tried = False  # guarded-by: _lock
_error: Optional[str] = None  # guarded-by: _lock

_ERRORS = {1: "cannot open file", 2: "not a PNG", 3: "PNG decode error",
           4: "bad arguments"}
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libd3dnative-{digest}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile to a per-pid temp path and rename it into place (concurrent
    processes may build at once; a rename is atomic, ``g++ -o`` is not).
    Returns None, or the failed build's last line that names an error
    (else its last line)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", tmp, "-lpng", "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.rename(tmp, lib)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        out = (getattr(e, "stderr", None) or getattr(e, "stdout", None)
               or str(e)).strip().splitlines()
        named = [line for line in out if "error" in line.lower()]
        return (named or out or [type(e).__name__])[-1]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not path.exists():
            _error = _build(path)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _error = str(e)
            return None
        lib.d3d_version.restype = ctypes.c_int
        lib.d3d_decode.restype = ctypes.c_int
        lib.d3d_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_float)]
        lib.d3d_pool_create.restype = ctypes.c_void_p
        lib.d3d_pool_create.argtypes = [ctypes.c_int]
        lib.d3d_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.d3d_pool_decode.restype = ctypes.c_int
        lib.d3d_pool_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        if lib.d3d_version() != 1:
            _error = f"decoder ABI version {lib.d3d_version()}, want 1"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native decoder built and loaded (built on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the decoder is unavailable (the build's error line, or the load
    error); None when it is available."""
    _load()
    return _error


_shared_pool: Optional["DecoderPool"] = None  # guarded-by: _pool_lock
_pool_lock = threading.Lock()


def shared_pool() -> Optional["DecoderPool"]:
    """The process-wide decoder pool (made on first use); None when the
    native runtime is unavailable."""
    global _shared_pool
    if _load() is None:      # before _pool_lock: _load takes its own lock
        return None
    with _pool_lock:
        if _shared_pool is None:
            _shared_pool = DecoderPool()
        return _shared_pool


def decode_image(path: str, size: int) -> np.ndarray:
    """Decode, box-resize and normalise one PNG through the native
    runtime; raises ``IOError`` with the decoder's error code's meaning."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_error}")
    out = np.empty((size, size, 3), np.float32)
    err = lib.d3d_decode(path.encode(), size,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if err:
        raise IOError(f"{_ERRORS.get(err, err)}: {path}")
    return out


class DecoderPool:
    """Persistent native worker pool: ``decode_batch(paths, size) ->
    [N, size, size, 3]``.  Its threads never take the GIL while decoding,
    so the host assembles the next batch during device compute."""

    def __init__(self, num_threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native decoder unavailable: {_error}")
        self._lib = lib
        self._pool = lib.d3d_pool_create(num_threads)
        if not self._pool:
            raise RuntimeError("pool creation failed")

    def decode_batch(self, paths: Sequence[str], size: int) -> np.ndarray:
        n = len(paths)
        out = np.empty((n, size, size, 3), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        err = self._lib.d3d_pool_decode(
            self._pool, arr, n, size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if err:
            raise IOError(f"batch decode failed: {_ERRORS.get(err, err)}")
        return out

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.d3d_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:
            pass
