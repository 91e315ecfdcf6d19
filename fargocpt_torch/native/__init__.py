"""Native (C++) runtime components, bound via ctypes.

An asynchronous snapshot writer (``async_writer.cpp``, the JAX package's
source verbatim) replaces the reference's MPI-IO collective output
(src/polargrid.cpp:135-186), so disk I/O overlaps with the device's work.

The shared library is built on first use with the system ``g++`` into
``build/fargocpt_torch/`` at the root of the checkout, under a hash of the
source and flags, so a stale build is never loaded; when no compiler is
available, ``AsyncFileWriter`` writes synchronously with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "async_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "fargocpt_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libasyncwriter_{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    """Compile under a temporary name and rename, so a concurrent reader
    never finds half a library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False


def load_library():
    """Load (building if needed) the native library, or return None."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.awriter_create.argtypes = []
    lib.awriter_create.restype = ctypes.c_void_p
    lib.awriter_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_void_p, ctypes.c_size_t]
    lib.awriter_submit.restype = None
    lib.awriter_flush.argtypes = [ctypes.c_void_p]
    lib.awriter_flush.restype = None
    lib.awriter_errors.argtypes = [ctypes.c_void_p]
    lib.awriter_errors.restype = ctypes.c_long
    lib.awriter_bytes_written.argtypes = [ctypes.c_void_p]
    lib.awriter_bytes_written.restype = ctypes.c_longlong
    lib.awriter_pending.argtypes = [ctypes.c_void_p]
    lib.awriter_pending.restype = ctypes.c_size_t
    lib.awriter_destroy.argtypes = [ctypes.c_void_p]
    lib.awriter_destroy.restype = None
    _lib = lib
    return lib


class AsyncFileWriter:
    """Background-thread file writer; falls back to synchronous writes when
    the native library is unavailable. Arrays are written as float64."""

    def __init__(self):
        self._lib = load_library()
        self._handle = self._lib.awriter_create() if self._lib else None

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def write(self, path, array):
        import numpy as np
        data = np.ascontiguousarray(array, dtype=np.float64)
        if self._handle is None:
            data.tofile(path)
            return
        buf = data.tobytes()   # snapshot copy; the C++ side copies again
        self._lib.awriter_submit(self._handle, str(path).encode(),
                                 buf, len(buf))

    def flush(self):
        if self._handle is not None:
            self._lib.awriter_flush(self._handle)

    @property
    def errors(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.awriter_errors(self._handle))

    def close(self):
        if self._handle is not None:
            self._lib.awriter_flush(self._handle)
            self._lib.awriter_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
