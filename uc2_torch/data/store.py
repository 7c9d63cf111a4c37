"""U2S record store: writer and reader (a copy of uc2_tpu/data/store.py).

A store is one file: a 24-byte header, the records' payloads (raw, or LZ4
blocks for payloads of at least ``compress_threshold`` bytes) and a flat
index of (offset, stored length, raw length, codec, key); see
``uc2_torch/csrc/u2s.cpp`` for the layout. Values are msgpack; a numpy
array is the map ``{b"__nd__": 1, b"dtype": ..., b"shape": ..., b"data":
raw bytes}``.

The msgpack codec is the port's own (``pack_value`` / ``unpack_value``):
nil, bool, ints of every width, float32/float64, str, bin, array and map,
which is all the records use. Its bytes are those of ``msgpack.packb(...,
use_bin_type=True)``, so the two packages write identical stores.

``StoreReader(native=True)`` reads through the native library (mmap, LZ4,
a thread pool for ``batch_get``); ``native=False`` is a pure-Python mmap
reader with a pure-Python LZ4 block decoder. ``READS`` counts the records
read by each path.
"""

from __future__ import annotations

import ctypes
import mmap
import struct
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from uc2_torch.data import native_build

MAGIC = b"U2S1"
CODEC_RAW = 0
CODEC_LZ4 = 1
# records read through each path, for callers that must know which ran
READS = {"native": 0, "python": 0}


# ------------------------------------------------------------------ msgpack
def _default(obj):
    if isinstance(obj, np.ndarray):
        return {b"__nd__": 1, b"dtype": obj.dtype.str,
                b"shape": list(obj.shape), b"data": obj.tobytes()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"cannot pack {type(obj)}")


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int,
              codes: Sequence[int], what: str):
    """A container or byte-string header: the fix form below ``fix_max``,
    else the first of the 8/16/32-bit forms (``codes``, None for a width
    the type lacks) that holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, ("B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"{what} is too large to pack")


def _pack_int(out: bytearray, o: int):
    if 0 <= o < 0x80:
        out.append(o)
    elif -0x20 <= o < 0:
        out.append(o & 0xFF)
    elif o > 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if o <= top:
                out.append(code)
                out += struct.pack(fmt, o)
                return
        raise OverflowError("int too big to pack")
    else:
        for code, fmt, low in ((0xD0, "b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if o >= low:
                out.append(code)
                out += struct.pack(fmt, o)
                return
        raise OverflowError("int too big to pack")


def _pack(o, out: bytearray, default_used: bool = False):
    """msgpack's type order: None, bool, int, float, bytes, str, dict,
    list/tuple, memoryview, then ``_default`` once."""
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(out, o)
    elif isinstance(o, float):
        out.append(0xCB)
        out += struct.pack(">d", o)
    elif isinstance(o, (bytes, bytearray)):
        _pack_len(out, len(o), None, 0, (0xC4, 0xC5, 0xC6), "bytes")
        out += o
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str")
        out += b
    elif isinstance(o, dict):
        _pack_len(out, len(o), 0x80, 15, (None, 0xDE, 0xDF), "dict")
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(o, (list, tuple)):
        _pack_len(out, len(o), 0x90, 15, (None, 0xDC, 0xDD), "list")
        for v in o:
            _pack(v, out)
    elif isinstance(o, memoryview):
        _pack(o.tobytes(), out)
    elif not default_used:
        _pack(_default(o), out, default_used=True)
    else:
        raise TypeError(f"cannot serialize {o!r}")


def pack_value(value: Any) -> bytes:
    """The bytes ``msgpack.packb(value, default=..., use_bin_type=True)``
    gives with the store's ndarray encoding."""
    out = bytearray()
    _pack(value, out)
    return bytes(out)


def _object_hook(obj):
    if obj.get(b"__nd__") == 1 or obj.get("__nd__") == 1:
        dtype = obj.get(b"dtype", obj.get("dtype"))
        shape = obj.get(b"shape", obj.get("shape"))
        data = obj.get(b"data", obj.get("data"))
        return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: bytes, p: int):
    """(object, next offset) of the value at offset p."""
    c = buf[p]
    p += 1
    if c < 0x80:
        return c, p
    if c >= 0xE0:
        return c - 0x100, p
    if 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c == 0xC0:
        return None, p
    elif c == 0xC2:
        return False, p
    elif c == 0xC3:
        return True, p
    elif c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, buf, p)[0], p + struct.calcsize(fmt)
    elif c in _LENGTHS:
        fmt, kind = _LENGTHS[c]
        n = struct.unpack_from(fmt, buf, p)[0]
        p += struct.calcsize(fmt)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
    if kind == "bin":
        return bytes(buf[p:p + n]), p + n
    if kind == "str":
        return bytes(buf[p:p + n]).decode("utf-8"), p + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, p = _unpack(buf, p)
            items.append(v)
        return items, p
    d = {}
    for _ in range(n):
        k, p = _unpack(buf, p)
        v, p = _unpack(buf, p)
        d[k] = v
    return _object_hook(d), p


def unpack_value(buf: bytes) -> Any:
    """``msgpack.unpackb(buf, raw=False, strict_map_key=False)`` with the
    ndarray hook: str as str, bin as bytes, arrays as lists, ndarray maps
    as read-only numpy arrays over the record's bytes."""
    value, p = _unpack(buf, 0)
    if p != len(buf):
        raise ValueError(f"{len(buf) - p} bytes of extra data after the value")
    return value


# ---------------------------------------------------------------------- LZ4
def lz4_block_decompress(src: bytes, raw_len: int) -> bytes:
    """Decode one LZ4 block (the format ``LZ4_compress_default`` writes)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:                 # the last sequence has literals only
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - off
        if off == 0 or start < 0:
            raise IOError("corrupt LZ4 block: bad match offset")
        if off >= ml:
            out += out[start:start + ml]
        else:                      # an overlapping match repeats the tail
            out += (out[start:] * (ml // off + 1))[:ml]
    if len(out) != raw_len:
        raise IOError(f"corrupt LZ4 block: {len(out)} bytes, not {raw_len}")
    return bytes(out)


# ------------------------------------------------------------------- writer
class StoreWriter:
    """Append-only writer; call close() (or use as a context manager).
    Payloads of at least ``compress_threshold`` bytes are LZ4-compressed
    through the native library when that shrinks them; ``compress=True``
    builds the library and raises if it cannot."""

    def __init__(self, path: str, compress: bool = True,
                 compress_threshold: int = 128):
        self.path = path
        self.lib = native_build.load() if compress else None
        self.compress = compress
        self.threshold = compress_threshold
        self.f = open(path, "wb")
        self.f.write(MAGIC + struct.pack("<IQQ", 0, 0, 0))
        self.entries: List[tuple] = []
        self.offset = 24

    def put(self, key: str, value: Any, raw: Optional[bytes] = None):
        blob = raw if raw is not None else pack_value(value)
        codec = CODEC_RAW
        out = blob
        if self.compress and len(blob) >= self.threshold:
            bound = self.lib.u2s_lz4_bound(len(blob))
            dst = ctypes.create_string_buffer(bound)
            n = self.lib.u2s_lz4_compress(blob, len(blob), dst, bound)
            if 0 < n < len(blob):
                out = dst.raw[:n]
                codec = CODEC_LZ4
        self.f.write(out)
        self.entries.append((key.encode(), self.offset, len(out), len(blob),
                             codec))
        self.offset += len(out)

    def close(self):
        index_offset = self.offset
        for key, off, stored, rawlen, codec in self.entries:
            self.f.write(struct.pack("<QQQBH", off, stored, rawlen, codec,
                                     len(key)))
            self.f.write(key)
        self.f.seek(4)
        self.f.write(struct.pack("<IQQ", 0, len(self.entries), index_offset))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ------------------------------------------------------------------- reader
class StoreReader:
    """Key-value reader over a U2S file: the native library (``native=True``,
    with ``n_threads`` decoding a ``batch_get``) or pure Python."""

    def __init__(self, path: str, native: bool = True, n_threads: int = 8):
        self.path = path
        self.lib = native_build.load() if native else None
        self.handle = None
        self._index: Optional[Dict[bytes, tuple]] = None
        self._mm = None
        if self.lib is not None:
            self.handle = self.lib.u2s_open(path.encode(), n_threads)
            if not self.handle:
                raise IOError(f"u2s_open failed for {path}")
        else:
            self._open_python()

    def _open_python(self):
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:4] != MAGIC:
            raise IOError(f"bad magic in {self.path}")
        n, index_offset = struct.unpack("<QQ", self._mm[8:24])
        self._index = {}
        p = index_offset
        for _ in range(n):
            off, stored, rawlen, codec, klen = struct.unpack(
                "<QQQBH", self._mm[p:p + 27])
            key = self._mm[p + 27:p + 27 + klen]
            p += 27 + klen
            self._index[bytes(key)] = (off, stored, rawlen, codec)

    def __len__(self):
        if self.handle:
            return self.lib.u2s_num_records(self.handle)
        return len(self._index)

    def keys(self) -> List[str]:
        """Every record key, in index order (read from the file's index by
        the Python reader: the native handle does not enumerate)."""
        if self._index is None:
            tmp = StoreReader(self.path, native=False)
            try:
                return tmp.keys()
            finally:
                tmp.close()
        return [k.decode("utf-8") for k in self._index]

    def get_raw(self, key: str) -> Optional[bytes]:
        if self.handle:
            k = key.encode()
            n = self.lib.u2s_raw_len(self.handle, k)
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(int(n))
            got = self.lib.u2s_get(self.handle, k, buf, n)
            if got < 0:
                raise IOError(f"u2s_get({key}) -> {got}")
            READS["native"] += 1
            return ctypes.string_at(buf, got)
        ent = self._index.get(key.encode())
        if ent is None:
            return None
        off, stored, rawlen, codec = ent
        blob = self._mm[off:off + stored]
        READS["python"] += 1
        if codec == CODEC_RAW:
            return blob
        return lz4_block_decompress(blob, rawlen)

    def batch_get_raw(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        if not self.handle:
            return [self.get_raw(k) for k in keys]
        n = len(keys)
        enc = [k.encode() for k in keys]
        lens = [self.lib.u2s_raw_len(self.handle, k) for k in enc]
        bufs = [ctypes.create_string_buffer(max(int(l), 1)) for l in lens]
        key_arr = (ctypes.c_char_p * n)(*enc)
        out_arr = (ctypes.c_char_p * n)(
            *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
        cap_arr = (ctypes.c_int64 * n)(*[max(int(l), 0) for l in lens])
        res_arr = (ctypes.c_int64 * n)()
        self.lib.u2s_batch_get(self.handle, key_arr, n, out_arr, cap_arr,
                               res_arr)
        READS["native"] += sum(1 for i in range(n) if res_arr[i] >= 0)
        return [ctypes.string_at(bufs[i], res_arr[i]) if res_arr[i] >= 0
                else None for i in range(n)]

    def __getitem__(self, key: str):
        raw = self.get_raw(key)
        if raw is None:
            raise KeyError(key)
        return unpack_value(raw)

    def get(self, key: str, default=None):
        raw = self.get_raw(key)
        return default if raw is None else unpack_value(raw)

    def batch_get(self, keys: Sequence[str]) -> List[Any]:
        return [None if raw is None else unpack_value(raw)
                for raw in self.batch_get_raw(keys)]

    def close(self):
        if self.handle:
            self.lib.u2s_close(self.handle)
            self.handle = None
        elif self._mm is not None:
            self._mm.close()
            self._f.close()
            self._mm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
