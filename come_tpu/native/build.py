"""Build + load the native library (g++ at first use, cached .so)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "walker.cpp"
_SO = _HERE / "build" / "libcomewalk.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    _SO.parent.mkdir(exist_ok=True)
    # build under a per-process name and rename into place: concurrent
    # first uses (test workers, processes of one launch) never see a
    # half-written library
    tmp = _SO.with_name(f".{_SO.name}.{os.getpid()}.tmp")
    cmd = [
        "g++",
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-o",
        str(tmp),
        str(_SRC),
        "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _SO)
    return True


def load_native():
    """Returns the ctypes CDLL, building it on first use; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        lib = ctypes.CDLL(str(_SO))
        lib.come_random_walks.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # indptr
            ctypes.POINTER(ctypes.c_int32),  # indices
            ctypes.c_int64,  # num_nodes
            ctypes.POINTER(ctypes.c_int32),  # starts
            ctypes.c_int64,  # num_walks
            ctypes.c_int32,  # length
            ctypes.c_uint64,  # seed
            ctypes.c_float,  # restart_prob
            ctypes.POINTER(ctypes.c_int32),  # out
            ctypes.c_int32,  # num_threads
        ]
        lib.come_random_walks.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None
