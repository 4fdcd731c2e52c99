"""Pure-python read-only LMDB parser (the port's own copy of
nshmc_tpu/utils/lmdb_reader.py, which has no JAX in it; the port imports
nothing of the JAX package).

The reference's LSUN dataset (datasets/lsun.py:11-61) reads through the
`lmdb` C library. The reader only needs sequential access to committed
key/value pairs, so this module parses the on-disk LMDB format directly
(struct layout per LMDB 0.9's mdb.c: MDB_meta / MDB_page / MDB_node,
64-bit build):

  meta pages 0/1   16-byte page header + MDB_meta {magic 0xBEEFC0DE,
                   version, address, mapsize, dbs[2] (MDB_db: pad/flags/
                   depth/branch/leaf/overflow/entries/root), last_pg, txnid}
                   — the live meta is the one with the larger txnid
  branch pages     flags & 0x01; node ptr array after the header; node
                   {lo, hi, flags, ksize, key...}; child pgno = lo |
                   hi<<16 | flags<<32
  leaf pages       flags & 0x02; node {lo, hi, flags, ksize, key, data};
                   datasize = lo | hi<<16; F_BIGDATA (0x01) stores an
                   8-byte overflow pgno instead of inline data
  overflow pages   flags & 0x04; pb_pages consecutive pages, data
                   contiguous from offset 16 of the first page

Supports iteration and random access over the main DB. No write support,
no named sub-databases, no DUPSORT (LSUN uses none of those).
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF

_PAGE_HDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_META = struct.Struct("<IIQQ")               # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")             # pad, flags, depth, branch,
                                             # leaf, overflow, entries, root
_NODE = struct.Struct("<HHHH")               # lo, hi, flags, ksize


class LMDBError(ValueError):
    pass


class LMDBReader:
    """Read-only view of an LMDB environment directory or data file."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._parse_meta()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- format parsing ----------------------------------------------------

    def _read(self, off: int, n: int) -> bytes:
        self._f.seek(off)
        b = self._f.read(n)
        if len(b) != n:
            raise LMDBError(f"short read at {off}")
        return b

    def _parse_one_meta(self, raw: bytes):
        # page header then MDB_meta
        off = _PAGE_HDR.size
        magic, version, _addr, _mapsize = _META.unpack_from(raw, off)
        if magic != MDB_MAGIC:
            raise LMDBError(f"bad LMDB magic {magic:#x}")
        off += _META.size
        dbs = []
        for _ in range(2):
            dbs.append(_DB.unpack_from(raw, off))
            off += _DB.size
        last_pg, txnid = struct.unpack_from("<QQ", raw, off)
        return dbs, last_pg, txnid

    def _parse_meta(self):
        # page size lives in dbs[0].md_pad; bootstrap with the default
        head = self._read(0, 4096 * 2)
        dbs0, _, txn0 = self._parse_one_meta(head[:4096])
        psize = dbs0[0][0] or 4096
        if psize != 4096:
            head = self._read(0, psize * 2)
        try:
            dbs1, _, txn1 = self._parse_one_meta(head[psize: 2 * psize])
        except LMDBError:
            dbs1, txn1 = None, -1
        dbs = dbs0 if txn0 >= txn1 else dbs1
        self.page_size = psize
        main = dbs[1]
        self.entries = main[6]
        self._root = main[7]
        self._depth = main[2]

    def _page(self, pgno: int) -> bytes:
        return self._read(pgno * self.page_size, self.page_size)

    def _iter_pages(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        raw = self._page(pgno)
        _pg, _pad, flags, lower, _upper = _PAGE_HDR.unpack_from(raw, 0)
        nkeys = (lower - _PAGE_HDR.size) // 2
        ptrs = struct.unpack_from(f"<{nkeys}H", raw, _PAGE_HDR.size)
        if flags & P_LEAF2:
            raise LMDBError("LEAF2 (dupfixed) pages unsupported")
        if flags & P_BRANCH:
            for p in ptrs:
                lo, hi, fl, ksize = _NODE.unpack_from(raw, p)
                child = lo | (hi << 16) | (fl << 32)
                yield from self._iter_pages(child)
        elif flags & P_LEAF:
            for p in ptrs:
                lo, hi, fl, ksize = _NODE.unpack_from(raw, p)
                key = raw[p + _NODE.size: p + _NODE.size + ksize]
                dsize = lo | (hi << 16)
                if fl & F_BIGDATA:
                    (ov_pgno,) = struct.unpack_from(
                        "<Q", raw, p + _NODE.size + ksize)
                    data = self._read_overflow(ov_pgno, dsize)
                else:
                    doff = p + _NODE.size + ksize
                    data = raw[doff: doff + dsize]
                yield key, data
        else:
            raise LMDBError(f"unexpected page flags {flags:#x} at {pgno}")

    def _read_overflow(self, pgno: int, dsize: int) -> bytes:
        hdr = self._read(pgno * self.page_size, _PAGE_HDR.size)
        _pg, _pad, flags, _lo, _up = _PAGE_HDR.unpack_from(hdr, 0)
        if not flags & P_OVERFLOW:
            raise LMDBError(f"page {pgno} is not an overflow page")
        return self._read(pgno * self.page_size + _PAGE_HDR.size, dsize)

    # -- public API ----------------------------------------------------------

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self._root == P_INVALID:
            return
        yield from self._iter_pages(self._root)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def get(self, key: bytes) -> Optional[bytes]:
        for k, v in self.items():
            if k == key:
                return v
        return None

    def __len__(self) -> int:
        return self.entries
