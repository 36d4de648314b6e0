"""Pure-Python LMDB data-file reader/writer, no liblmdb dependency (port
of hop_tpu/data/lmdbfile.py; the same code, with `close` and the context
manager added).

The reference keeps every dataset in LMDB environments read with the
``lmdb`` package (data_preprocessor.py:26, lmdb_data_loader.py:99-101),
which is not installed here. This module parses the on-disk ``data.mdb``
format (LMDB 0.9.x, file-format version 1) directly:

- meta pages 0/1 (magic 0xBEEFC0DE), the live one picked by txnid;
- the MAIN-db B+tree: branch pages -> leaf pages -> nodes, with
  F_BIGDATA values on contiguous overflow pages;
- page size recovered from meta (FREE-db ``md_pad`` field).

``LmdbReader`` is enough to iterate the reference's source and cache
LMDBs in key order (cursor semantics of lmdb_data_loader.py:263).
``write_lmdb`` builds a valid single-version environment (leaf pages,
one branch level when needed, overflow pages for large values, both
meta pages) so tests can fabricate reference-format fixtures that real
liblmdb would also open.

Layout constants follow lmdb.h / mdb.c (OpenLDAP LMDB 0.9):
page header = 16 bytes {pgno u64, pad u16, flags u16, lower u16, upper
u16 | overflow-pages u32}; node = {lo u16, hi u16, flags u16, ksize u16,
key, data}; meta = {magic u32, version u32, address u64, mapsize u64,
dbs[2] x 48B, last_pg u64, txnid u64}.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

_PAGEHDR = 16
_NODEHDR = 8
_P_INVALID = 0xFFFFFFFFFFFFFFFF


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only iterator over an LMDB environment's MAIN database; a
    context manager that closes the file map on exit."""

    def __init__(self, path: str):
        self.path = _data_path(path)
        # mmap, not read(): real TED source LMDBs are multi-GB and only
        # the touched pages should ever enter memory
        import mmap as _mmap
        self._file = open(self.path, "rb")
        self.buf = _mmap.mmap(self._file.fileno(), 0,
                              access=_mmap.ACCESS_READ)
        # meta 0 is at offset 0; its psize field locates meta 1
        m0 = self._parse_meta(0)
        m1 = self._parse_meta((m0 or {"psize": 4096})["psize"])
        metas = [m for m in (m0, m1) if m is not None]
        if not metas:
            raise ValueError(f"{self.path}: no valid LMDB meta page")
        self.meta = max(metas, key=lambda m: m["txnid"])
        self.psize = self.meta["psize"]
        self.n_entries = self.meta["main_entries"]
        self.root = self.meta["main_root"]

    def _parse_meta(self, off: int):
        if off + _PAGEHDR + 48 * 2 + 48 > len(self.buf):
            return None
        base = off + _PAGEHDR
        magic, version = struct.unpack_from("<II", self.buf, base)
        if magic != MAGIC or version not in (VERSION, 999):
            return None
        # address u64, mapsize u64 then dbs[2]
        dbs_off = base + 8 + 8 + 8
        free_pad, = struct.unpack_from("<I", self.buf, dbs_off)
        main_off = dbs_off + 48
        (pad, flags, depth, branch_pages, leaf_pages, overflow_pages,
         entries, root) = struct.unpack_from("<IHHQQQQQ", self.buf, main_off)
        last_pg, txnid = struct.unpack_from("<QQ", self.buf, main_off + 48)
        return dict(psize=free_pad or 4096, txnid=txnid, main_root=root,
                    main_entries=entries, depth=depth)

    # -- page access --------------------------------------------------------

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + _PAGEHDR > len(self.buf):
            raise ValueError(f"page {pgno} beyond file end")
        return off

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self.buf, off + 10)[0]

    def _nkeys(self, off: int) -> int:
        lower, = struct.unpack_from("<H", self.buf, off + 12)
        return (lower - _PAGEHDR) >> 1

    def _node(self, page_off: int, i: int):
        ptr, = struct.unpack_from("<H", self.buf, page_off + _PAGEHDR + 2 * i)
        noff = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self.buf, noff)
        key = self.buf[noff + _NODEHDR: noff + _NODEHDR + ksize]
        return lo, hi, flags, ksize, key, noff

    def _leaf_value(self, lo, hi, flags, ksize, noff) -> bytes:
        dsize = lo | (hi << 16)
        dstart = noff + _NODEHDR + ksize
        if flags & F_BIGDATA:
            ovpg, = struct.unpack_from("<Q", self.buf, dstart)
            ovoff = self._page(ovpg)
            return self.buf[ovoff + _PAGEHDR: ovoff + _PAGEHDR + dsize]
        return self.buf[dstart: dstart + dsize]

    # -- traversal ----------------------------------------------------------

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        if self.root == _P_INVALID:
            return
        yield from self._walk(self.root)

    def _walk(self, pgno: int):
        off = self._page(pgno)
        flags = self._page_flags(off)
        n = self._nkeys(off)
        if flags & P_BRANCH:
            for i in range(n):
                lo, hi, nflags, ksize, key, noff = self._node(off, i)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        elif flags & P_LEAF:
            for i in range(n):
                lo, hi, nflags, ksize, key, noff = self._node(off, i)
                yield key, self._leaf_value(lo, hi, nflags, ksize, noff)
        else:
            raise ValueError(f"page {pgno}: unexpected flags {flags:#x}")

    def get(self, key: bytes):
        for k, v in self.items():
            if k == key:
                return v
        return None

    def __len__(self):
        return self.n_entries

    def stat(self):
        return {"entries": self.n_entries, "psize": self.psize,
                "depth": self.meta["depth"]}

    def close(self):
        self.buf.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writer (fixtures / exports)
# ---------------------------------------------------------------------------

def _node_bytes(key: bytes, lo: int, hi: int, flags: int,
                data: bytes) -> bytes:
    return struct.pack("<HHHH", lo, hi, flags, len(key)) + key + data


def write_lmdb(path: str, items: dict | list, psize: int = 4096,
               mapsize: int = 1 << 30) -> str:
    """Write ``items`` (bytes->bytes) as a valid LMDB environment at
    ``path`` (a directory; creates ``data.mdb``). Values larger than a
    quarter page go to overflow pages, mirroring liblmdb's policy of
    spilling oversized nodes."""
    if isinstance(items, dict):
        items = sorted(items.items())
    else:
        items = sorted(items)
    os.makedirs(path, exist_ok=True)

    def page(flags: int, nodes: list[bytes], pgno_hint: int) -> bytes:
        lower = _PAGEHDR + 2 * len(nodes)
        total = sum((len(n) + 1) & ~1 for n in nodes)
        upper = psize - total
        if lower > upper:
            raise ValueError("page overflow — node list too large")
        ptrs, body = [], b""
        pos = psize
        for n in nodes:
            sz = (len(n) + 1) & ~1
            pos -= sz
            ptrs.append(pos)
        hdr = struct.pack("<QHHHH", pgno_hint, 0, flags, lower, upper)
        buf = bytearray(psize)
        buf[:16] = hdr
        struct.pack_into(f"<{len(ptrs)}H", buf, _PAGEHDR, *ptrs)
        for n, p in zip(nodes, ptrs):
            buf[p:p + len(n)] = n
        return bytes(buf)

    # 1. stage nodes, spilling large values to overflow pages
    max_inline = psize // 4
    n_overflow = 0
    staged: list[tuple[bytes, bytes]] = []
    for key, value in items:
        if len(value) > max_inline:
            n_ov_pages = (len(value) + _PAGEHDR + psize - 1) // psize
            ov = bytearray(n_ov_pages * psize)
            # overflow page header: pgno filled at layout time, flags, pages
            ov[:16] = struct.pack("<QHHI", 0, 0, P_OVERFLOW, n_ov_pages)
            ov[16:16 + len(value)] = value
            node = ("OV", key, len(value), bytes(ov), n_ov_pages)
            n_overflow += n_ov_pages
        else:
            node = ("IN", key, len(value), value, 0)
        staged.append(node)

    # assemble leaves with page-capacity accounting
    leaves: list[list] = []
    cur: list = []
    cur_bytes = _PAGEHDR
    for node in staged:
        kind, key, dsize, payload, novp = node
        body = 8 if kind == "OV" else dsize
        need = 2 + ((_NODEHDR + len(key) + body + 1) & ~1)
        if cur and cur_bytes + need > psize:
            leaves.append(cur)
            cur, cur_bytes = [], _PAGEHDR
        cur.append(node)
        cur_bytes += need
    if cur:
        leaves.append(cur)

    # 2. lay out pages: leaves (with their overflow pages) then branch
    leaf_pgnos: list[int] = []
    leaf_keys: list[bytes] = []
    raw_pages: list[tuple[int, bytes]] = []   # (pgno, raw)
    next_pg = 2
    for leaf in leaves:
        nodes = []
        leaf_pg = next_pg
        next_pg += 1
        for kind, key, dsize, payload, novp in leaf:
            if kind == "OV":
                ov_pg = next_pg
                next_pg += novp
                ov = bytearray(payload)
                struct.pack_into("<Q", ov, 0, ov_pg)
                raw_pages.append((ov_pg, bytes(ov)))
                nodes.append(_node_bytes(key, dsize & 0xFFFF, dsize >> 16,
                                         F_BIGDATA,
                                         struct.pack("<Q", ov_pg)))
            else:
                nodes.append(_node_bytes(key, dsize & 0xFFFF, dsize >> 16,
                                         0, payload))
        raw_pages.append((leaf_pg, page(P_LEAF, nodes, leaf_pg)))
        leaf_pgnos.append(leaf_pg)
        leaf_keys.append(leaf[0][1])

    depth = 1
    root = leaf_pgnos[0] if leaf_pgnos else _P_INVALID
    n_branch = 0
    if len(leaf_pgnos) > 1:
        # one branch level (fixture scale); first branch key is empty
        bnodes = []
        for i, (pg, k) in enumerate(zip(leaf_pgnos, leaf_keys)):
            bkey = b"" if i == 0 else k
            bnodes.append(_node_bytes(bkey, pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                                      (pg >> 32) & 0xFFFF, b""))
        root = next_pg
        next_pg += 1
        raw_pages.append((root, page(P_BRANCH, bnodes, root)))
        depth, n_branch = 2, 1

    last_pg = next_pg - 1

    # 3. metas
    def meta(txnid: int) -> bytes:
        free_db = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0,
                              _P_INVALID)
        main_db = struct.pack("<IHHQQQQQ", 0, 0, depth if items else 0,
                              n_branch, len(leaf_pgnos), n_overflow,
                              len(items), root)
        body = struct.pack("<IIQQ", MAGIC, VERSION, 0, mapsize) \
            + free_db + main_db + struct.pack("<QQ", last_pg, txnid)
        hdr = struct.pack("<QHHI", txnid & 1, 0, P_META, 0)
        return (hdr + body).ljust(psize, b"\0")

    out = _data_path(path) if path.endswith(".mdb") else \
        os.path.join(path, "data.mdb")
    with open(out, "wb") as f:
        f.write(meta(0))
        f.write(meta(1))
        for pgno, raw in sorted(raw_pages):
            assert f.tell() == pgno * psize, (f.tell(), pgno)
            f.write(raw)
    return out
