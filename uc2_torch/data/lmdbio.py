"""Minimal pure-Python LMDB *file format* reader and writer (a copy of
uc2_tpu/data/lmdbio.py).

The original UC2 release keeps its datasets in LMDB environments; no
``lmdb`` wheel is needed here, so the importer (``python -m
uc2_torch.import_lmdb``) and its tests read and write the on-disk B+tree
format directly (the ``data.mdb`` file, little-endian, 4096-byte pages):

  page 0/1   meta pages (magic 0xBEEFC0DE, version 1; reader picks the
             larger txnid)
  leaf page  node-pointer array growing up, nodes packed down from the top
  branch     same, first node with empty key; node carries child pgno
  overflow   contiguous page run for values too large for a leaf node

Scope: read/write of the default (main) database with string keys --
exactly what the original release uses (no named sub-DBs, no dupsort).
The writer builds a read-only snapshot (bulk load, sorted keys, txnid 1);
it is a fixture/import tool, not a transactional store. Its bytes are
those of the reference package's writer for the same items.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PSIZE = 4096
PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

NODESIZE = 8                       # node header bytes
NODEMAX = (PSIZE - PAGEHDRSZ) // 2 & ~1   # 2040: larger data → overflow

_META = struct.Struct("<IIQQ")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")        # pad,flags,depth,branch,leaf,ovf,entries,root
_TAIL = struct.Struct("<QQ")            # last_pg, txnid
_PGHDR = struct.Struct("<QHHHH")        # pgno, pad, flags, lower, upper
_OVHDR = struct.Struct("<QHHI")         # pgno, pad, flags, pb_pages
_NODE = struct.Struct("<HHHH")          # lo, hi, flags, ksize


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only walker over a data.mdb main DB."""

    def __init__(self, path: str):
        self.path = _data_path(path)
        with open(self.path, "rb") as f:
            self.buf = f.read()
        best: Optional[Tuple[int, Tuple]] = None
        for pgno in (0, 1):
            meta = self._parse_meta(pgno)
            if meta is not None and (best is None or meta[0] > best[0]):
                best = meta
        if best is None:
            raise ValueError(f"{self.path}: no valid LMDB meta page")
        self.txnid, self.root, self.entries = best

    def _parse_meta(self, pgno: int):
        off = pgno * PSIZE
        if off + PSIZE > len(self.buf):
            return None
        hdr = _PGHDR.unpack_from(self.buf, off)
        if not hdr[2] & P_META:
            return None
        magic, version, _addr, _maps = _META.unpack_from(self.buf,
                                                         off + PAGEHDRSZ)
        if magic != MAGIC or version != VERSION:
            return None
        main_off = off + PAGEHDRSZ + _META.size + _DB.size  # skip free DB
        db = _DB.unpack_from(self.buf, main_off)
        last_pg, txnid = _TAIL.unpack_from(self.buf, main_off + _DB.size)
        return txnid, db[7], db[6]

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        off = pgno * PSIZE
        _, _, flags, lower, upper = _PGHDR.unpack_from(self.buf, off)
        return off, flags, lower, upper

    def _nodes(self, pgno: int) -> Iterator[Tuple[int, int, bytes, int]]:
        """Yield (flags, data_size_or_pgno, key, data_off) per node."""
        off, flags, lower, upper = self._page(pgno)
        n = (lower - PAGEHDRSZ) // 2
        for i in range(n):
            (ptr,) = struct.unpack_from("<H", self.buf,
                                        off + PAGEHDRSZ + 2 * i)
            noff = off + ptr
            lo, hi, nflags, ksize = _NODE.unpack_from(self.buf, noff)
            key = self.buf[noff + NODESIZE:noff + NODESIZE + ksize]
            yield nflags, lo | (hi << 16), key, noff + NODESIZE + ksize

    def _leaf_items(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off, flags, _, _ = self._page(pgno)
        if flags & P_LEAF:
            for nflags, dsize, key, doff in self._nodes(pgno):
                if nflags & F_BIGDATA:
                    (ovf,) = struct.unpack_from("<Q", self.buf, doff)
                    o = ovf * PSIZE
                    yield key, self.buf[o + PAGEHDRSZ:o + PAGEHDRSZ + dsize]
                else:
                    yield key, self.buf[doff:doff + dsize]
        elif flags & P_BRANCH:
            for _, child, _, _ in self._nodes(pgno):
                yield from self._leaf_items(child)
        else:
            raise ValueError(f"page {pgno}: unexpected flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.root == P_INVALID:
            return
        yield from self._leaf_items(self.root)

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        while True:
            off, flags, _, _ = self._page(pgno)
            nodes = list(self._nodes(pgno))
            if flags & P_LEAF:
                for nflags, dsize, k, doff in nodes:
                    if k == key:
                        if nflags & F_BIGDATA:
                            (ovf,) = struct.unpack_from("<Q", self.buf, doff)
                            o = ovf * PSIZE
                            return self.buf[o + PAGEHDRSZ:
                                            o + PAGEHDRSZ + dsize]
                        return self.buf[doff:doff + dsize]
                return None
            # branch: last child whose key <= target (node 0 key is empty)
            child = nodes[0][1]
            for _, pg, k, _ in nodes[1:]:
                if k <= key:
                    child = pg
                else:
                    break
            pgno = child


class _PageBuilder:
    """One leaf/branch page being packed (ptrs up, nodes down)."""

    def __init__(self, pgno: int, flags: int):
        self.pgno = pgno
        self.flags = flags
        self.ptrs: List[int] = []
        self.node_bytes: List[bytes] = []
        self.upper = PSIZE

    def fits(self, node_len: int) -> bool:
        lower = PAGEHDRSZ + 2 * (len(self.ptrs) + 1)
        return lower <= self.upper - ((node_len + 1) & ~1)

    def add(self, node: bytes):
        nlen = (len(node) + 1) & ~1     # 2-byte node alignment
        self.upper -= nlen
        self.ptrs.append(self.upper)
        self.node_bytes.append(node.ljust(nlen, b"\0"))

    def render(self) -> bytes:
        lower = PAGEHDRSZ + 2 * len(self.ptrs)
        page = bytearray(PSIZE)
        _PGHDR.pack_into(page, 0, self.pgno, 0, self.flags, lower,
                         self.upper)
        p = PAGEHDRSZ
        for ptr in self.ptrs:
            struct.pack_into("<H", page, p, ptr)
            p += 2
        for ptr, nb in zip(self.ptrs, self.node_bytes):
            page[ptr:ptr + len(nb)] = nb
        return bytes(page)


def _leaf_node(key: bytes, data: bytes, big_pgno: Optional[int]) -> bytes:
    if big_pgno is None:
        lo, hi = len(data) & 0xFFFF, len(data) >> 16
        return _NODE.pack(lo, hi, 0, len(key)) + key + data
    lo, hi = len(data) & 0xFFFF, len(data) >> 16
    return _NODE.pack(lo, hi, F_BIGDATA, len(key)) + key \
        + struct.pack("<Q", big_pgno)


def _branch_node(key: bytes, child_pgno: int) -> bytes:
    lo, hi = child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF
    # pgno bits 32..47 go in mn_flags (files here never get that large)
    fl = (child_pgno >> 32) & 0xFFFF
    return _NODE.pack(lo, hi, fl, len(key)) + key


class LmdbWriter:
    """Bulk-build a read-only LMDB environment (data.mdb) from a dict."""

    def __init__(self, path: str):
        if not os.path.splitext(path)[1]:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        self.path = path
        self.items: Dict[bytes, bytes] = {}

    def put(self, key, value: bytes):
        if isinstance(key, str):
            key = key.encode("utf-8")
        assert len(key) <= 511, "LMDB max key size"
        self.items[key] = bytes(value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not exc[0]:
            self.close()

    def close(self):
        pages: List[bytes] = [b"", b""]          # meta slots, filled last
        next_pg = 2

        def emit_raw(raw: bytes) -> int:
            nonlocal next_pg
            pages.append(raw)
            pg = next_pg
            next_pg += 1
            return pg

        def emit_page(builder: "_PageBuilder") -> int:
            builder.pgno = next_pg
            return emit_raw(builder.render())

        n_overflow = 0
        # ---- leaves (sorted keys; overflow runs for big values)
        leaves: List[Tuple[bytes, int]] = []     # (first_key, pgno)
        leaf = None
        n_leaf = 0
        for key in sorted(self.items):
            data = self.items[key]
            big = NODESIZE + len(key) + len(data) > NODEMAX
            if big:
                npg = -(-(len(data)) // (PSIZE - PAGEHDRSZ))
                first = bytearray(PAGEHDRSZ)
                _OVHDR.pack_into(first, 0, next_pg, 0, P_OVERFLOW, npg)
                blob = bytes(first) + data
                blob = blob.ljust(npg * PSIZE, b"\0")
                ovf_pg = next_pg
                for i in range(npg):
                    emit_raw(blob[i * PSIZE:(i + 1) * PSIZE])
                n_overflow += npg
                node = _leaf_node(key, data, ovf_pg)
            else:
                node = _leaf_node(key, data, None)
            if leaf is None or not leaf.fits(len(node)):
                if leaf is not None:
                    leaves.append((leaf_first, emit_page(leaf)))
                    n_leaf += 1
                leaf = _PageBuilder(0, P_LEAF)   # pgno set at emit
                leaf_first = key
            leaf.add(node)
        if leaf is not None:
            leaves.append((leaf_first, emit_page(leaf)))
            n_leaf += 1

        # ---- branch levels
        n_branch = 0
        depth = 1
        level = leaves
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            br = None
            for first_key, pg in level:
                key = b"" if br is None else first_key
                node = _branch_node(key, pg)
                if br is not None and not br.fits(len(node)):
                    nxt.append((br_first, emit_page(br)))
                    n_branch += 1
                    br = None
                    node = _branch_node(b"", pg)
                if br is None:
                    br = _PageBuilder(0, P_BRANCH)
                    br_first = first_key
                br.add(node)
            nxt.append((br_first, emit_page(br)))
            n_branch += 1
            level = nxt

        root = level[0][1] if level else P_INVALID
        if not self.items:
            depth = 0
        last_pg = next_pg - 1
        mapsize = next_pg * PSIZE

        def meta(pgno: int, txnid: int) -> bytes:
            page = bytearray(PSIZE)
            _PGHDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
            off = PAGEHDRSZ
            _META.pack_into(page, off, MAGIC, VERSION, 0, mapsize)
            off += _META.size
            # free DB: empty
            _DB.pack_into(page, off, PSIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
            off += _DB.size
            # main DB
            _DB.pack_into(page, off, PSIZE, 0, depth, n_branch, n_leaf,
                          n_overflow, len(self.items), root)
            off += _DB.size
            _TAIL.pack_into(page, off, last_pg, txnid)
            return bytes(page)

        pages[0] = meta(0, 0)
        pages[1] = meta(1, 1)
        with open(self.path, "wb") as f:
            for raw in pages:
                f.write(raw)
