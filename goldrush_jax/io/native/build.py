"""Build + ctypes bindings for the native seqio reader.

Compiled from ``seqio.cpp`` with g++ on first use (no pybind11 needed); the
shared object is never committed.  Falls back cleanly if the toolchain is
unavailable — callers must check ``available()``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "seqio.cpp")
_SO = os.path.join(_DIR, "_seqio.so")
_lock = threading.Lock()
_lib = None
_failed = False


def build(src: str = _SRC, so: str = _SO) -> bool:
    """Compile ``src`` into ``so`` unless ``so`` is newer.  The compiler
    writes a temporary file next to ``so`` that is renamed into place, so
    processes that build at the same time never load a half-written
    library."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return True
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
             "-o", tmp, "-lz"],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not build():
            _failed = True
            return None
        lib = ctypes.CDLL(_SO)
        lib.seqio_open.restype = ctypes.c_void_p
        lib.seqio_open.argtypes = [ctypes.c_char_p]
        lib.seqio_close.argtypes = [ctypes.c_void_p]
        lib.seqio_read_block.restype = ctypes.c_int64
        lib.seqio_read_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None
