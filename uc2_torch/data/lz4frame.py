"""LZ4 *frame* codec over the system liblz4 (port of
uc2_tpu/data/lz4frame.py): ``compress`` and ``decompress`` as python-lz4's
``lz4.frame`` gives them, without that wheel.

The original UC2 release stores its text LMDB values as LZ4 frames of
msgpack; the importer (``python -m uc2_torch.import_lmdb``) reads them
through this module, and its tests write them. The library is found as
the native store reader finds it (``data/native_build.py``): the linker's
``lz4``, then the runtime ``liblz4.so.1``; without it every call raises,
naming the library.
"""

from __future__ import annotations

import ctypes
import ctypes.util

from uc2_torch.data.native_build import LZ4_CANDIDATES

_lib = None


def _lz4():
    global _lib
    if _lib is None:
        lib = _load()
        lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
        lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t,
                                                ctypes.c_void_p]
        lib.LZ4F_compressFrame.restype = ctypes.c_size_t
        lib.LZ4F_compressFrame.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_void_p]
        lib.LZ4F_isError.restype = ctypes.c_uint
        lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
        lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
        lib.LZ4F_createDecompressionContext.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
        lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
        lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
        lib.LZ4F_decompress.restype = ctypes.c_size_t
        lib.LZ4F_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
        _lib = lib
    return _lib


def _load() -> ctypes.CDLL:
    """The system liblz4, or a RuntimeError naming each place tried."""
    names = [ctypes.util.find_library("lz4")] + [
        c for c in LZ4_CANDIDATES if not c.startswith("-")] + ["liblz4.so.1"]
    tried = []
    for name in names:
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError as e:
            tried.append(f"{name}: {e}")
    raise RuntimeError("uc2_torch: the LZ4 frame codec needs the system "
                       "library liblz4 (liblz4.so.1); not found:\n"
                       + "\n".join(tried))


LZ4F_VERSION = 100


def compress(data: bytes) -> bytes:
    """lz4.frame.compress(data) equivalent (default preferences)."""
    lib = _lz4()
    n = len(data)
    bound = lib.LZ4F_compressFrameBound(n, None)
    out = ctypes.create_string_buffer(bound)
    written = lib.LZ4F_compressFrame(out, bound, data, n, None)
    if lib.LZ4F_isError(written):
        raise RuntimeError(f"LZ4F_compressFrame error code {written}")
    return out.raw[:written]


def decompress(data: bytes, chunk: int = 1 << 20) -> bytes:
    """lz4.frame.decompress(data) equivalent (streaming, any frame)."""
    lib = _lz4()
    ctx = ctypes.c_void_p()
    err = lib.LZ4F_createDecompressionContext(ctypes.byref(ctx),
                                              LZ4F_VERSION)
    if lib.LZ4F_isError(err):
        raise RuntimeError(f"LZ4F ctx error code {err}")
    try:
        src = ctypes.create_string_buffer(data, len(data))
        out_parts = []
        src_off = 0
        dst = ctypes.create_string_buffer(chunk)
        while src_off < len(data):
            src_size = ctypes.c_size_t(len(data) - src_off)
            dst_size = ctypes.c_size_t(chunk)
            rc = lib.LZ4F_decompress(
                ctx, dst, ctypes.byref(dst_size),
                ctypes.byref(src, src_off), ctypes.byref(src_size), None)
            if lib.LZ4F_isError(rc):
                raise RuntimeError(f"LZ4F_decompress error code {rc}")
            if dst_size.value:
                out_parts.append(dst.raw[:dst_size.value])
            if src_size.value == 0 and dst_size.value == 0:
                break  # stalled (truncated input)
            src_off += src_size.value
            if rc == 0 and src_off >= len(data):
                break
        return b"".join(out_parts)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)
