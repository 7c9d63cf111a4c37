"""Build and load the native U2S store library (``uc2_torch/csrc/u2s.cpp``)
with ``g++`` and ctypes.

The library is built at first use into ``build/uc2_torch_native/`` at the
root of the repository and linked against the system's LZ4 (the runtime
``liblz4.so.1`` when no development symlink exists). A failed build raises
and names each command tried with its stderr: the caller asked for the
native reader, and a quiet fall back to the Python reader would hide it.
The pure-Python reader is ``StoreReader(path, native=False)``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "uc2_torch", "csrc", "u2s.cpp")
OUT_DIR = os.path.join(_ROOT, "build", "uc2_torch_native")
OUT = os.path.join(OUT_DIR, "libu2s.so")
LZ4_CANDIDATES = ("-llz4", "/usr/lib/x86_64-linux-gnu/liblz4.so.1",
                  "/lib/x86_64-linux-gnu/liblz4.so.1")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[RuntimeError] = None


def build(force: bool = False) -> str:
    """Compile the library unless an up-to-date one exists; return its
    path. Each process writes a file of its own and renames it into place,
    so processes that build at once do not clobber each other."""
    os.makedirs(OUT_DIR, exist_ok=True)
    if (not force and os.path.exists(OUT)
            and os.path.getmtime(OUT) >= os.path.getmtime(SRC)):
        return OUT
    tmp = f"{OUT}.{os.getpid()}.tmp"
    tried = []
    for lz4 in LZ4_CANDIDATES:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               SRC, "-o", tmp, lz4]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            tried.append(f"$ {' '.join(cmd)}\n{e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, OUT)
            return OUT
        tried.append(f"$ {' '.join(cmd)}\n{r.stderr.strip()}")
    raise RuntimeError("uc2_torch: the native U2S library did not build:\n"
                       + "\n".join(tried))


def load() -> ctypes.CDLL:
    """The native library, built first if needed; raises RuntimeError when
    it cannot be built (again on every later call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            path = build()
        except RuntimeError as e:
            _error = e
            raise
        lib = ctypes.CDLL(path)
        lib.u2s_open.restype = ctypes.c_void_p
        lib.u2s_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.u2s_close.argtypes = [ctypes.c_void_p]
        lib.u2s_num_records.restype = ctypes.c_int64
        lib.u2s_num_records.argtypes = [ctypes.c_void_p]
        lib.u2s_raw_len.restype = ctypes.c_int64
        lib.u2s_raw_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.u2s_get.restype = ctypes.c_int64
        lib.u2s_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int64]
        lib.u2s_batch_get.restype = ctypes.c_int
        lib.u2s_batch_get.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.u2s_lz4_bound.restype = ctypes.c_int
        lib.u2s_lz4_bound.argtypes = [ctypes.c_int]
        lib.u2s_lz4_compress.restype = ctypes.c_int
        lib.u2s_lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib
