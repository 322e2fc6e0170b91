"""Minimal pure-Python LMDB environment reader/writer (read-optimized).

Capability parity enabler for the reference's LMDB stack (lmdbif.H:13
RAII wrappers over liblmdb; lmdb_caffe_io.cc:35 test_lmdb reads ImageNet
Datum DBs). This environment has no `lmdb` module, so instead of leaving
the paths feature-gated-off (round-1 state), this module implements the
on-disk LMDB data format directly:

  * reader: both meta pages, newest valid txn, B+tree walk (branch/leaf
    nodes, F_BIGDATA overflow chains), full iteration + point get,
  * writer: bulk-load of sorted key/value pairs into a compact tree
    (bottom-up leaf packing, branch fan-in, overflow pages for big
    values, dual meta pages) — the classic read-optimized mdb_load shape.

Layout facts (LMDB file format v1, 64-bit, little-endian; see lmdb.h /
mdb.c in the canonical distribution): 4096-byte pages; 16-byte page
header (pgno u64, pad u16, flags u16, lower u16, upper u16 — the
lower/upper pair is pb_pages u32 for overflow pages); meta page =
header + MDB_meta (magic 0xBEEFC0DE, version 1, address, mapsize,
dbs[2] of 48 bytes each, last_pg, txnid); 8-byte node header
(lo u16, hi u16, flags u16, ksize u16) followed by key then (leaf)
value; branch child pgno packed lo|hi<<16|flags<<32; node offsets are
even, stored in a u16 array growing up from the header while node
bodies grow down from the page end.

If the real `lmdb` module is present it is preferred by callers (see
apps/eval_cls.py open_lmdb_kv_iter); this is the always-available fallback
and the fixture *writer* for tests and the smoke.

The port's copy of boda_tpu/utils/lmdbmini.py (platform-free).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, Iterator, Optional

from ..core.error import RtErr

PSIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8
MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF
# max in-leaf node size: (psize - hdr) / MDB_MINKEYS(2), even-aligned
NODEMAX = ((PSIZE - PAGEHDRSZ) // 2) & ~1


def _data_path(path) -> Path:
    p = Path(path)
    return p / "data.mdb" if p.is_dir() else p


class LmdbMini:
    """Read-only LMDB environment over one data.mdb file."""

    def __init__(self, path):
        self.path = _data_path(path)
        if not self.path.exists():
            raise RtErr(f"lmdb: no such env '{path}'")
        self.buf = self.path.read_bytes()
        best = None
        for pg in (0, 1):
            m = self._parse_meta(pg)
            if m is not None and (best is None or m["txnid"] > best["txnid"]):
                best = m
        if best is None:
            raise RtErr(f"lmdb: '{path}' has no valid meta page")
        self.meta = best
        self.entries = best["main"]["entries"]
        self.depth = best["main"]["depth"]

    def _parse_meta(self, pgno: int) -> Optional[dict]:
        off = pgno * PSIZE
        if len(self.buf) < off + PSIZE:
            return None
        flags = struct.unpack_from("<H", self.buf, off + 10)[0]
        if not flags & P_META:
            return None
        o = off + PAGEHDRSZ
        magic, version = struct.unpack_from("<II", self.buf, o)
        if magic != MAGIC or version != VERSION:
            return None
        o += 8 + 8 + 8  # magic+version, address, mapsize
        dbs = []
        for _ in range(2):
            pad, dflags, depth, br, lf, ov, ent, root = struct.unpack_from(
                "<IHHQQQQQ", self.buf, o)
            dbs.append({"flags": dflags, "depth": depth, "entries": ent,
                        "root": root})
            o += 48
        last_pg, txnid = struct.unpack_from("<QQ", self.buf, o)
        return {"txnid": txnid, "last_pg": last_pg, "free": dbs[0],
                "main": dbs[1]}

    # ---- page access ----

    def _page(self, pgno: int) -> int:
        off = pgno * PSIZE
        if off + PSIZE > len(self.buf):
            raise RtErr(f"lmdb: pgno {pgno} out of file")
        return off

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self.buf, off + 10)[0]

    def _nkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self.buf, off + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, off: int, i: int) -> tuple[int, int, int, int, int]:
        """→ (lo, hi, flags, ksize, node_off_abs)."""
        ptr = struct.unpack_from("<H", self.buf, off + PAGEHDRSZ + 2 * i)[0]
        no = off + ptr
        lo, hi, fl, ks = struct.unpack_from("<HHHH", self.buf, no)
        return lo, hi, fl, ks, no

    def _leaf_kv(self, off: int, i: int) -> tuple[bytes, bytes]:
        lo, hi, fl, ks, no = self._node(off, i)
        key = self.buf[no + NODESZ:no + NODESZ + ks]
        dsize = lo | (hi << 16)
        if fl & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self.buf, no + NODESZ + ks)[0]
            oo = self._page(ovpg)
            return key, self.buf[oo + PAGEHDRSZ:oo + PAGEHDRSZ + dsize]
        do = no + NODESZ + ks
        return key, self.buf[do:do + dsize]

    def _branch_child(self, off: int, i: int) -> int:
        lo, hi, fl, _ks, _no = self._node(off, i)
        return lo | (hi << 16) | (fl << 32)

    def _branch_key(self, off: int, i: int) -> bytes:
        _lo, _hi, _fl, ks, no = self._node(off, i)
        return self.buf[no + NODESZ:no + NODESZ + ks]

    # ---- queries ----

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        root = self.meta["main"]["root"]
        if root == P_INVALID:
            return
        yield from self._walk(root)

    def _walk(self, pgno: int) -> Iterator[tuple[bytes, bytes]]:
        off = self._page(pgno)
        fl = self._page_flags(off)
        n = self._nkeys(off)
        if fl & P_LEAF:
            for i in range(n):
                yield self._leaf_kv(off, i)
        elif fl & P_BRANCH:
            for i in range(n):
                yield from self._walk(self._branch_child(off, i))
        else:
            raise RtErr(f"lmdb: unexpected page flags {fl:#x} at pgno {pgno}")

    def get(self, key: bytes) -> Optional[bytes]:
        root = self.meta["main"]["root"]
        if root == P_INVALID:
            return None
        pgno = root
        while True:
            off = self._page(pgno)
            fl = self._page_flags(off)
            n = self._nkeys(off)
            if fl & P_LEAF:
                for i in range(n):
                    k, v = self._leaf_kv(off, i)
                    if k == key:
                        return v
                return None
            # branch: last child whose key <= target (node 0 key = -inf)
            ci = 0
            for i in range(1, n):
                if self._branch_key(off, i) <= key:
                    ci = i
                else:
                    break
            pgno = self._branch_child(off, ci)

    def stat(self) -> dict:
        m = self.meta["main"]
        return {"entries": m["entries"], "depth": m["depth"],
                "psize": PSIZE, "last_pg": self.meta["last_pg"]}


# ---- writer (bulk load) ----

def _mk_page(pgno: int, flags: int, nodes: list[bytes]) -> bytes:
    """Assemble one branch/leaf page from already-encoded node bodies."""
    nn = len(nodes)
    lower = PAGEHDRSZ + 2 * nn
    upper = PSIZE
    ptrs = []
    body = bytearray(PSIZE)
    for nd in nodes:
        sz = (len(nd) + 1) & ~1  # even-align
        upper -= sz
        ptrs.append(upper)
        body[upper:upper + len(nd)] = nd
    if lower > upper:
        raise RtErr("lmdb write: page overflow (node packing bug)")
    struct.pack_into("<QHHHH", body, 0, pgno, 0, flags, lower, upper)
    struct.pack_into(f"<{nn}H", body, PAGEHDRSZ, *ptrs)
    return bytes(body)


def _leaf_node(key: bytes, val: bytes, big_pgno: Optional[int]) -> bytes:
    ds = len(val)
    if big_pgno is not None:
        return (struct.pack("<HHHH", ds & 0xFFFF, ds >> 16, F_BIGDATA,
                            len(key)) + key + struct.pack("<Q", big_pgno))
    return struct.pack("<HHHH", ds & 0xFFFF, ds >> 16, 0, len(key)) + key + val


def _branch_node(key: bytes, child: int) -> bytes:
    return struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                       (child >> 32) & 0xFFFF, len(key)) + key


def write_lmdb(path, items: Iterable[tuple[bytes, bytes]],
               subdir: bool = True) -> dict:
    """Bulk-write sorted-unique (key, value) pairs as an LMDB env; returns
    the stat dict. `subdir=True` writes <path>/data.mdb (+ empty lock)."""
    kvs = sorted(items)
    for i in range(1, len(kvs)):
        if kvs[i][0] == kvs[i - 1][0]:
            raise RtErr(f"lmdb write: duplicate key {kvs[i][0]!r}")
    pages: dict[int, bytes] = {}
    next_pg = 2  # 0,1 = metas

    def alloc() -> int:
        nonlocal next_pg
        next_pg += 1
        return next_pg - 1

    n_overflow = 0
    # ---- pack leaves ----
    leaves: list[tuple[bytes, int]] = []  # (first_key, pgno)
    cur_nodes: list[bytes] = []
    cur_first: Optional[bytes] = None
    cur_used = PAGEHDRSZ

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_used
        if not cur_nodes:
            return
        pg = alloc()
        pages[pg] = _mk_page(pg, P_LEAF, cur_nodes)
        leaves.append((cur_first, pg))
        cur_nodes, cur_first, cur_used = [], None, PAGEHDRSZ

    for k, v in kvs:
        if len(k) > 511:
            raise RtErr(f"lmdb write: key too long ({len(k)} > 511)")
        big_pg = None
        if NODESZ + len(k) + len(v) > NODEMAX:
            npgs = (PAGEHDRSZ + len(v) + PSIZE - 1) // PSIZE
            big_pg = alloc()
            n_overflow += npgs
            ov = bytearray(npgs * PSIZE)
            struct.pack_into("<QHHI", ov, 0, big_pg, 0, P_OVERFLOW, npgs)
            ov[PAGEHDRSZ:PAGEHDRSZ + len(v)] = v
            pages[big_pg] = bytes(ov)
            for extra in range(1, npgs):
                alloc()  # overflow pages are contiguous
        nd = _leaf_node(k, v, big_pg)
        sz = ((len(nd) + 1) & ~1) + 2  # body + ptr slot
        if cur_used + sz > PSIZE:
            flush_leaf()
        if cur_first is None:
            cur_first = k
        cur_nodes.append(nd)
        cur_used += sz
    flush_leaf()

    # ---- branch levels bottom-up ----
    depth = 1 if leaves else 0
    level = leaves
    n_branch = 0
    while len(level) > 1:
        depth += 1
        nxt: list[tuple[bytes, int]] = []
        cur_nodes, cur_first, cur_used = [], None, PAGEHDRSZ
        first_in_page = True

        def flush_branch():
            nonlocal cur_nodes, cur_first, cur_used, first_in_page, n_branch
            if not cur_nodes:
                return
            pg = alloc()
            pages[pg] = _mk_page(pg, P_BRANCH, cur_nodes)
            nxt.append((cur_first, pg))
            n_branch += 1
            cur_nodes, cur_first, cur_used = [], None, PAGEHDRSZ
            first_in_page = True

        for fk, child in level:
            key = b"" if first_in_page else fk  # node 0 carries no key
            nd = _branch_node(key, child)
            sz = ((len(nd) + 1) & ~1) + 2
            if cur_used + sz > PSIZE:
                flush_branch()
                key = b""
                nd = _branch_node(key, child)
                sz = ((len(nd) + 1) & ~1) + 2
            if cur_first is None:
                cur_first = fk
            cur_nodes.append(nd)
            cur_used += sz
            first_in_page = False
        flush_branch()
        level = nxt

    root = level[0][1] if level else P_INVALID
    last_pg = next_pg - 1
    n_leaf = len(leaves)

    # ---- metas ----
    fsize = (last_pg + 1) * PSIZE
    mapsize = max(fsize, 1 << 20)

    def meta_page(pgno: int, txnid: int, rootpg: int, ent: int, dep: int) -> bytes:
        b = bytearray(PSIZE)
        struct.pack_into("<QHHHH", b, 0, pgno, 0, P_META, 0, 0)
        o = PAGEHDRSZ
        struct.pack_into("<II", b, o, MAGIC, VERSION)
        o += 8
        struct.pack_into("<QQ", b, o, 0, mapsize)
        o += 16
        # FREE_DBI: md_pad carries the page size
        struct.pack_into("<IHHQQQQQ", b, o, PSIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
        o += 48
        struct.pack_into("<IHHQQQQQ", b, o, 0, 0, dep, n_branch if dep else 0,
                         n_leaf if dep else 0, n_overflow if dep else 0,
                         ent, rootpg)
        o += 48
        struct.pack_into("<QQ", b, o, last_pg, txnid)
        return bytes(b)

    out = bytearray(fsize)
    out[0:PSIZE] = meta_page(0, 0, P_INVALID, 0, 0)
    out[PSIZE:2 * PSIZE] = meta_page(1, 1, root, len(kvs), depth)
    for pg, data in pages.items():
        out[pg * PSIZE:pg * PSIZE + len(data)] = data

    p = Path(path)
    if subdir:
        p.mkdir(parents=True, exist_ok=True)
        (p / "data.mdb").write_bytes(bytes(out))
        (p / "lock.mdb").write_bytes(b"")
    else:
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(bytes(out))
    return {"entries": len(kvs), "depth": depth, "last_pg": last_pg}
