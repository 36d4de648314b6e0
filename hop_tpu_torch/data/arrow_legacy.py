"""Legacy ``pyarrow.serialize`` (Arrow <= 0.17) codec in numpy and struct
alone (port of hop_tpu/data/arrow_legacy.py, which sits on pyarrow's IPC
reader and writer; this module needs no pyarrow).

The reference stores every LMDB value with the long-removed
``pyarrow.serialize(obj).to_buffer()`` (data_preprocessor.py:172,
lmdb_data_loader.py:122). Its wire format:

  int32 num_tensors, [int32 num_sparse_tensors (arrow >= 0.15)],
  int32 num_ndarrays, int32 num_buffers
  <pad to 8>  IPC stream: a Schema message, one RecordBatch message with
              one dense-union column, the end-of-stream marker
  per tensor, then per ndarray: <pad to 64> an IPC Tensor message
  per buffer: <pad to 64> int64 length + bytes

An IPC message is a flatbuffer (Arrow's Message.fbs, Schema.fbs,
Tensor.fbs) framed by its int32 length (before Arrow 0.15) or by
0xFFFFFFFF and the length (0.15 on), then its body; a zero length ends a
stream. This module reads and writes those flatbuffers itself (`_Table`,
`_Builder`): vtables, tables, vectors, unions, strings and structs.

Python objects are a dense union whose children are created on demand,
one per value type, in first-appearance order: "bool" (bit-packed),
"int" (int64), "float" / "double", "string" / "bytes" (int32 offsets),
"ndarray" / "tensor" / "buffer" (int32 indices into their sections),
"list", "tuple", "set" (list<union>, a sub-union per nesting level) and
"dict" (struct<keys: list<union>, vals: list<union>>). The decoder goes by
the children's names. In V4 metadata a union carries a validity bitmap
buffer before its type ids (a null slot is None); V5 has none, so the
buffers are counted by the message's metadata version.

Unlike hop_tpu's decoder, "tensor", "ndarray" and "buffer" index each
their own section, as pyarrow's did; the two agree wherever a payload has
no tensors and no buffers, as every payload the reference wrote.
"""

from __future__ import annotations

import struct

import numpy as np

_IPC_ALIGN = 8
_TENSOR_ALIGN = 64
_CONTINUATION = 0xFFFFFFFF

# Message.fbs: MetadataVersion and the MessageHeader union's members
_V4, _V5 = 3, 4
_SCHEMA, _RECORD_BATCH, _TENSOR = 1, 3, 4
# Schema.fbs: the Type union's members, FloatingPoint's precisions, UnionMode
_INT, _FLOAT, _BINARY, _UTF8, _BOOL, _LIST, _STRUCT, _UNION = 2, 3, 4, 5, 6, 12, 13, 14
_PRECISION_DTYPE = {0: "<f2", 1: "<f4", 2: "<f8"}
_DTYPE_PRECISION = {"f2": 0, "f4": 1, "f8": 2}
_DENSE = 1

# what a wrong guess of the payload header raises while it is parsed
_FORMAT_ERRORS = (ValueError, TypeError, IndexError, KeyError, struct.error)


def _u32(buf, pos: int) -> int:
    return struct.unpack_from("<I", buf, pos)[0]


# ---------------------------------------------------------------------------
# flatbuffers
# ---------------------------------------------------------------------------

class _Table:
    """A flatbuffer table at `pos` of `buf`: field i is found through the
    vtable at pos - soffset; an offset field points forward by its uint32."""

    __slots__ = ("buf", "pos", "_vt", "_vt_size")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self._vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self._vt_size = struct.unpack_from("<H", buf, self._vt)[0]

    def _field(self, i: int):
        slot = 4 + 2 * i
        if slot >= self._vt_size:
            return None
        off = struct.unpack_from("<H", self.buf, self._vt + slot)[0]
        return self.pos + off if off else None

    def _target(self, i: int):
        p = self._field(i)
        return None if p is None else p + _u32(self.buf, p)

    def scalar(self, i: int, fmt: str, default=0):
        p = self._field(i)
        return default if p is None else struct.unpack_from(fmt, self.buf, p)[0]

    def struct(self, i: int, fmt: str):
        p = self._field(i)
        return None if p is None else struct.unpack_from(fmt, self.buf, p)

    def table(self, i: int):
        p = self._target(i)
        return None if p is None else _Table(self.buf, p)

    def union(self, i: int):
        """(member, table) of the union whose type is field i and value i + 1."""
        return self.scalar(i, "<B"), self.table(i + 1)

    def tables(self, i: int) -> list:
        v = self._target(i)
        if v is None:
            return []
        return [_Table(self.buf, v + 4 + 4 * k + _u32(self.buf, v + 4 + 4 * k))
                for k in range(_u32(self.buf, v))]

    def array(self, i: int, dtype, width: int = 1) -> np.ndarray:
        """A vector of scalars, or of structs of `width` scalars of one
        type, as (n,) or (n, width)."""
        v = self._target(i)
        n = 0 if v is None else _u32(self.buf, v)
        out = np.frombuffer(self.buf, dtype, n * width, v + 4) if n else np.zeros(0, dtype)
        return out.reshape(n, width) if width > 1 else out

    def string(self, i: int) -> str:
        v = self._target(i)
        if v is None:
            return ""
        return bytes(self.buf[v + 4: v + 4 + _u32(self.buf, v)]).decode("utf-8")


_INLINE = {"u8": ("<B", 1), "i16": ("<h", 2), "i32": ("<i", 4), "i64": ("<q", 8)}


class _Builder:
    """Lays a flatbuffer out front to back: each table's vtable just before
    it, the objects it points to after it (a uoffset points forward), every
    scalar aligned to its size from the buffer's start.

    A table is a dict {field index: spec}, a spec one of ("u8" | "i16" |
    "i32" | "i64", value), ("struct", bytes, alignment), ("table", dict),
    ("str", str), ("tables", [dict, ...]) or ("vector", bytes, element
    alignment, count)."""

    def __init__(self):
        self.buf = bytearray(4)      # the root offset, patched by finish

    def _pad(self, align: int, extra: int = 0):
        self.buf += bytes(-(len(self.buf) + extra) % align)

    def _patch(self, at: int, target: int):
        struct.pack_into("<I", self.buf, at, target - at)

    def finish(self, root: dict) -> bytes:
        self._patch(0, self.table(root))
        return bytes(self.buf)

    def table(self, fields: dict) -> int:
        inline = []
        for i, spec in fields.items():
            if spec[0] in _INLINE:
                fmt, size = _INLINE[spec[0]]
                inline.append((size, i, struct.pack(fmt, spec[1]), None))
            elif spec[0] == "struct":
                inline.append((spec[2], i, spec[1], None))
            else:                    # a uoffset, patched once its object is laid out
                inline.append((4, i, bytes(4), spec))
        inline.sort(key=lambda f: -f[0])
        where, size = {}, 4          # after the soffset, widest first
        for align, i, raw, _ in inline:
            size += -size % align
            where[i] = size
            size += len(raw)
        n_slots = max(fields, default=-1) + 1
        self._pad(2)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<HH{n_slots}H", 4 + 2 * n_slots, size,
                                *(where.get(i, 0) for i in range(n_slots)))
        self._pad(8)                 # the table's 8-byte fields land 8-aligned
        start = len(self.buf)
        self.buf += struct.pack("<i", start - vtable) + bytes(size - 4)
        for _, i, raw, _ in inline:
            self.buf[start + where[i]: start + where[i] + len(raw)] = raw
        for _, i, _, ref in inline:
            if ref is not None:
                self._patch(start + where[i], self._object(ref))
        return start

    def _object(self, spec) -> int:
        kind = spec[0]
        if kind == "table":
            return self.table(spec[1])
        self._pad(4)
        at = len(self.buf)
        if kind == "str":
            data = spec[1].encode("utf-8")
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
        elif kind == "tables":
            self.buf += struct.pack("<I", len(spec[1])) + bytes(4 * len(spec[1]))
            for k, t in enumerate(spec[1]):
                self._patch(at + 4 + 4 * k, self.table(t))
        else:                        # ("vector", raw, alignment, count)
            _, raw, align, count = spec
            self._pad(max(align, 4), 4)
            at = len(self.buf)
            self.buf += struct.pack("<I", count) + raw
        return at


# ---------------------------------------------------------------------------
# IPC messages
# ---------------------------------------------------------------------------

class _Message:
    __slots__ = ("version", "kind", "header", "body")

    def __init__(self, version, kind, header, body):
        self.version, self.kind, self.header, self.body = version, kind, header, body


def _read_message(buf: memoryview, pos: int):
    """The encapsulated message at `pos` in either framing and the
    position after its body; None for the end-of-stream marker."""
    if _u32(buf, pos) == _CONTINUATION:
        length = struct.unpack_from("<i", buf, pos + 4)[0]
        pos += 8
    else:                            # before Arrow 0.15: the length alone
        length = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
    if length == 0:
        return None, pos
    if length < 0 or pos + length > len(buf):
        raise ValueError(f"IPC message of {length} bytes at {pos} overruns the "
                         f"{len(buf)}-byte payload")
    meta = buf[pos: pos + length]
    msg = _Table(meta, _u32(meta, 0))
    kind, header = msg.union(1)
    start = pos + length
    body_length = msg.scalar(3, "<q")
    if body_length < 0 or start + body_length > len(buf):
        raise ValueError(f"IPC body of {body_length} bytes at {start} overruns the payload")
    return (_Message(msg.scalar(0, "<h"), kind, header, buf[start: start + body_length]),
            start + body_length)


def _frame(meta: bytes, legacy: bool, align: int = _IPC_ALIGN) -> bytes:
    """A message's flatbuffer in its frame, padded so that the body after
    it starts `align`-aligned when the frame does."""
    prefix = 4 if legacy else 8
    meta += bytes(-(prefix + len(meta)) % align)
    head = (struct.pack("<i", len(meta)) if legacy
            else struct.pack("<Ii", _CONTINUATION, len(meta)))
    return head + meta


def _message(kind: int, header: dict, body_length: int) -> bytes:
    return _Builder().finish({0: ("i16", _V4), 1: ("u8", kind), 2: ("table", header),
                              3: ("i64", body_length)})


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Field:
    """A schema field: name, Type member and table, children."""

    __slots__ = ("name", "type", "spec", "children")

    def __init__(self, t: _Table):
        self.name = t.string(0)
        self.type, self.spec = t.union(2)
        self.children = [_Field(c) for c in t.tables(5)]


class _Column:
    """One array of the record batch, its buffers turned into Python lists:
    `values` (scalars), `offsets` (lists, dense unions), `type_ids` and
    `child_of` (type code -> child) for unions, `valid` where there are
    nulls."""

    __slots__ = ("name", "valid", "values", "offsets", "type_ids", "child_of", "children")

    def __init__(self, name):
        self.name = name
        self.valid = self.values = self.offsets = self.type_ids = self.child_of = None
        self.children = []


def _bits(raw, n: int) -> list:
    return np.unpackbits(np.frombuffer(raw, np.uint8), count=n,
                         bitorder="little").astype(bool).tolist()


def _column(field: _Field, nodes, buffers, body, version: int) -> _Column:
    length, null_count = next(nodes)
    col = _Column(field.name)

    def take():
        off, n = next(buffers)
        if off < 0 or n < 0 or off + n > len(body):
            raise ValueError(f"buffer ({off}, {n}) overruns the {len(body)}-byte body")
        return body[off: off + n]

    def validity():
        raw = take()
        if null_count:
            col.valid = _bits(raw, length)

    t = field.type
    if t == _UNION:
        if version < _V5:            # V4 leads with a validity bitmap, V5 has none
            validity()
        col.type_ids = np.frombuffer(take(), np.int8, length).tolist()
        if field.spec.scalar(0, "<h") == _DENSE:
            col.offsets = np.frombuffer(take(), "<i4", length).tolist()
        codes = field.spec.array(1, "<i4").tolist() or range(len(field.children))
        col.child_of = {c: k for k, c in enumerate(codes)}
    elif t == _LIST:
        validity()
        col.offsets = np.frombuffer(take(), "<i4", length + 1).tolist()
    elif t == _STRUCT:
        validity()
    elif t in (_INT, _FLOAT, _BOOL):
        validity()
        if t == _BOOL:
            col.values = _bits(take(), length)
        else:
            dtype = (_PRECISION_DTYPE[field.spec.scalar(0, "<h")] if t == _FLOAT else
                     f"<{'i' if field.spec.scalar(1, '<B') else 'u'}"
                     f"{field.spec.scalar(0, '<i') // 8}")
            col.values = np.frombuffer(take(), dtype, length).tolist()
    elif t in (_UTF8, _BINARY):
        validity()
        offsets = np.frombuffer(take(), "<i4", length + 1).tolist()
        data = bytes(take())
        col.values = [data[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
        if t == _UTF8:
            col.values = [v.decode("utf-8") for v in col.values]
    else:
        raise ValueError(f"field {field.name!r}: Arrow type {t} is not one that "
                         "pyarrow.serialize wrote")
    if col.valid is not None and col.values is not None:
        col.values = [v if ok else None for v, ok in zip(col.values, col.valid)]
    col.children = [_column(c, nodes, buffers, body, version) for c in field.children]
    return col


def _tensor(header: _Table, body) -> np.ndarray:
    kind, spec = header.union(0)
    if kind == _FLOAT:
        dtype = _PRECISION_DTYPE[spec.scalar(0, "<h")]
    elif kind == _INT:
        dtype = f"<{'i' if spec.scalar(1, '<B') else 'u'}{spec.scalar(0, '<i') // 8}"
    else:
        raise ValueError(f"tensor of Arrow type {kind}: only ints and floats are read")
    shape = [d.scalar(0, "<q") for d in header.tables(2)]
    strides = header.array(3, "<i8").tolist() or None
    offset, _ = header.struct(4, "<qq")
    return np.ndarray(shape, np.dtype(dtype), buffer=body, offset=offset, strides=strides)


_SCALAR_TAGS = {
    "bool": bool, "int": int, "py2_int": int, "large_int": int,
    "float": float, "half_float": float, "double": float,
    "string": str, "unicode": str, "py2_string": bytes, "bytes": bytes,
}


def _items(lst: _Column, row: int, blobs: dict) -> list:
    sub = lst.children[0]
    return [_value(sub, j, blobs) for j in range(lst.offsets[row], lst.offsets[row + 1])]


def _value(union: _Column, i: int, blobs: dict):
    if union.valid is not None and not union.valid[i]:
        return None
    child = union.children[union.child_of[union.type_ids[i]]]
    row = union.offsets[i] if union.offsets is not None else i
    name = child.name
    if name in _SCALAR_TAGS:
        v = child.values[row]
        return None if v is None else _SCALAR_TAGS[name](v)
    if name in ("ndarray", "tensor", "buffer"):
        return blobs[name][child.values[row]]
    if name in ("list", "tuple", "set"):
        items = _items(child, row, blobs)
        return items if name == "list" else tuple(items) if name == "tuple" else set(items)
    if name == "dict":
        keys, vals = child.children
        return dict(zip(_items(keys, row, blobs), _items(vals, row, blobs)))
    raise ValueError(f"unknown legacy-arrow union tag {name!r}")


def deserialize(buf: bytes):
    """Decode a legacy ``pyarrow.serialize`` payload.

    The 0.14 header is [n_tensors, n_ndarrays, n_buffers] (+4 bytes pad),
    the 0.15+ header adds a sparse-tensor count after n_tensors; both end
    at byte 16 where the IPC stream begins. The words alone can be
    ambiguous (zero counts), so the plausible interpretation is tried
    first and the other when the payload does not parse under it."""
    data = bytes(buf)
    w = struct.unpack_from("<iiii", data, 0)
    v15 = (w[0], w[2], w[3])     # (n_tensors, n_ndarrays, n_buffers)
    v14 = (w[0], w[1], w[2])
    order = [v15, v14] if (w[1] == 0 and w[2] > 0) else [v14, v15]
    last_err = None
    for counts in order:
        if min(counts) < 0 or max(counts) > 10 ** 6:
            continue
        try:
            return _deserialize_with_counts(memoryview(data), *counts)
        except _FORMAT_ERRORS as e:  # wrong layout guess -> try the other
            last_err = e
    raise ValueError(f"cannot decode legacy-arrow payload "
                     f"(header words {w}): {last_err}")


def _deserialize_with_counts(buf: memoryview, n_tensors: int, n_ndarrays: int,
                             n_buffers: int):
    schema, pos = _read_message(buf, 16)
    if schema is None or schema.kind != _SCHEMA:
        raise ValueError("the IPC stream does not start with a schema")
    batch, pos = _read_message(buf, pos)
    if batch is None or batch.kind != _RECORD_BATCH:
        raise ValueError("the IPC stream holds no record batch")
    end, pos = _read_message(buf, pos)
    if end is not None:
        raise ValueError("the IPC stream holds more than one record batch")
    if batch.header.table(3) is not None:
        raise ValueError("a compressed record batch is not a legacy-arrow payload")
    fields = [_Field(f) for f in schema.header.tables(1)]
    nodes = iter(batch.header.array(1, "<i8", 2).tolist())
    buffers = iter(batch.header.array(2, "<i8", 2).tolist())
    root = _column(fields[0], nodes, buffers, batch.body, batch.version)

    blobs = {"tensor": [], "ndarray": [], "buffer": []}
    for name, n in (("tensor", n_tensors), ("ndarray", n_ndarrays)):
        for _ in range(n):
            pos += -pos % _TENSOR_ALIGN
            msg, pos = _read_message(buf, pos)
            if msg is None or msg.kind != _TENSOR:
                raise ValueError(f"{name} {len(blobs[name])}: not a tensor message")
            blobs[name].append(_tensor(msg.header, msg.body))
    for _ in range(n_buffers):
        pos += -pos % _TENSOR_ALIGN
        (size,) = struct.unpack_from("<q", buf, pos)
        pos += 8
        if size < 0 or pos + size > len(buf):
            raise ValueError(f"buffer of {size} bytes overruns the payload")
        blobs["buffer"].append(bytes(buf[pos: pos + size]))
        pos += size

    if root.type_ids is None and root.offsets is not None:   # root as list<union>
        root = root.children[0]
    if root.type_ids is None:
        raise ValueError(f"root column {root.name!r} is not a union")
    return _value(root, 0, blobs)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

class _Array:
    """An array to write: its field (name, Type member, type table), its
    length, its buffers, its children."""

    __slots__ = ("name", "type", "spec", "length", "buffers", "children")

    def __init__(self, name, type_, spec, length, buffers, children=()):
        self.name, self.type, self.spec = name, type_, spec
        self.length, self.buffers, self.children = length, buffers, list(children)

    def field(self) -> dict:
        return {0: ("str", self.name), 1: ("u8", 1), 2: ("u8", self.type),
                3: ("table", self.spec),
                5: ("tables", [c.field() for c in self.children])}

    def flatten(self, nodes: list, buffers: list):
        nodes.append((self.length, 0))
        buffers.extend(self.buffers)
        for c in self.children:
            c.flatten(nodes, buffers)


def _scalar_array(name: str, values: list) -> _Array:
    n = len(values)
    if name == "bool":
        bits = np.packbits(np.asarray(values, bool), bitorder="little").tobytes()
        return _Array(name, _BOOL, {}, n, [b"", bits])
    if name in ("int", "ndarray"):
        width = 64 if name == "int" else 32
        data = np.asarray(values, f"<i{width // 8}").tobytes()
        return _Array(name, _INT, {0: ("i32", width), 1: ("u8", 1)}, n, [b"", data])
    if name in ("float", "double"):
        dtype = "<f4" if name == "float" else "<f8"
        return _Array(name, _FLOAT, {0: ("i16", _DTYPE_PRECISION[dtype[1:]])}, n,
                      [b"", np.asarray(values, dtype).tobytes()])
    raw = [v.encode("utf-8") for v in values] if name == "string" else values
    offsets = np.cumsum([0] + [len(v) for v in raw]).astype("<i4").tobytes()
    return _Array(name, _UTF8 if name == "string" else _BINARY, {}, n,
                  [b"", offsets, b"".join(raw)])


class _SeqBuilder:
    """One dense union per nesting level (arrow 0.14's SequenceBuilder),
    children created lazily in first-appearance order."""

    def __init__(self, ndarrays: list):
        self.ndarrays = ndarrays
        self.type_ids: list[int] = []
        self.offsets: list[int] = []
        self.children: dict = {}        # name -> list of values, or a builder

    def _tag(self, name: str, make=list):
        if name not in self.children:
            self.children[name] = make()
        return list(self.children).index(name), self.children[name]

    def _emit(self, name: str, value):
        tid, child = self._tag(name)
        self.type_ids.append(tid)
        self.offsets.append(len(child))
        child.append(value)

    def append(self, obj):
        if obj is None:
            raise TypeError(
                "None is not supported by the legacy-arrow encoder (the "
                "reference's clip dicts contain no None values)")
        if isinstance(obj, (bool, np.bool_)):
            self._emit("bool", bool(obj))
        elif isinstance(obj, (int, np.integer)):
            self._emit("int", int(obj))
        elif isinstance(obj, np.float32):
            self._emit("float", float(obj))
        elif isinstance(obj, (float, np.floating)):
            self._emit("double", float(obj))
        elif isinstance(obj, str):
            self._emit("string", obj)
        elif isinstance(obj, bytes):
            self._emit("bytes", obj)
        elif isinstance(obj, np.ndarray):
            self._emit("ndarray", len(self.ndarrays))
            self.ndarrays.append(np.ascontiguousarray(obj))
        elif isinstance(obj, (list, tuple, set)):
            name = ("list" if isinstance(obj, list)
                    else "tuple" if isinstance(obj, tuple) else "set")
            tid, child = self._tag(name, lambda: _ListChild(self.ndarrays))
            self.type_ids.append(tid)
            self.offsets.append(child.append(list(obj)))
        elif isinstance(obj, dict):
            tid, child = self._tag("dict", lambda: _DictChild(self.ndarrays))
            self.type_ids.append(tid)
            self.offsets.append(child.append(obj))
        else:
            raise TypeError(f"unsupported type for legacy-arrow: {type(obj)}")

    def finish(self, name: str) -> _Array:
        children = [c.finish(k) if hasattr(c, "finish") else _scalar_array(k, c)
                    for k, c in self.children.items()]
        if not children:   # empty sequence: single dummy child keeps it valid
            children = [_scalar_array("int", [])]
        spec = {0: ("i16", _DENSE),
                1: ("vector", np.arange(len(children), dtype="<i4").tobytes(), 4,
                    len(children))}
        # V4: an empty validity bitmap leads the type ids
        return _Array(name, _UNION, spec, len(self.type_ids),
                      [b"", np.asarray(self.type_ids, np.int8).tobytes(),
                       np.asarray(self.offsets, "<i4").tobytes()], children)


class _ListChild:
    def __init__(self, ndarrays):
        self.sub = _SeqBuilder(ndarrays)
        self.offsets = [0]

    def append(self, items: list) -> int:
        for it in items:
            self.sub.append(it)
        self.offsets.append(len(self.sub.type_ids))
        return len(self.offsets) - 2

    def finish(self, name: str) -> _Array:
        return _Array(name, _LIST, {}, len(self.offsets) - 1,
                      [b"", np.asarray(self.offsets, "<i4").tobytes()],
                      [self.sub.finish("item")])


class _DictChild:
    def __init__(self, ndarrays):
        self.keys = _ListChild(ndarrays)
        self.vals = _ListChild(ndarrays)
        self.n = 0

    def append(self, d: dict) -> int:
        self.keys.append(list(d.keys()))
        self.vals.append(list(d.values()))
        self.n += 1
        return self.n - 1

    def finish(self, name: str) -> _Array:
        return _Array(name, _STRUCT, {}, self.n, [b""],
                      [self.keys.finish("keys"), self.vals.finish("vals")])


def _tensor_message(arr: np.ndarray) -> bytes:
    """An ndarray as an IPC Tensor message (0.15+ framing, V4 metadata),
    its body 64-aligned when the message is."""
    kind = arr.dtype.kind
    if kind == "f" and arr.dtype.itemsize in (2, 4, 8):
        type_, spec = _FLOAT, {0: ("i16", _DTYPE_PRECISION[f"f{arr.dtype.itemsize}"])}
    elif kind in "iu":
        type_, spec = _INT, {0: ("i32", 8 * arr.dtype.itemsize), 1: ("u8", int(kind == "i"))}
    else:
        raise TypeError(f"legacy-arrow tensors hold ints and floats, not {arr.dtype}")
    arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
    data = arr.tobytes()
    body = data + bytes(-len(data) % _IPC_ALIGN)
    header = {0: ("u8", type_), 1: ("table", spec),
              2: ("tables", [{0: ("i64", d)} for d in arr.shape]),
              3: ("vector", np.asarray(arr.strides, "<i8").tobytes(), 8, arr.ndim),
              4: ("struct", struct.pack("<qq", 0, len(data)), 8)}
    return _frame(_message(_TENSOR, header, len(body)), legacy=False,
                  align=_TENSOR_ALIGN) + body


def serialize(obj) -> bytes:
    """Encode ``obj`` in the legacy ``pyarrow.serialize`` wire format:
    the 0.14 header variant (three int32 counts), the IPC stream in the
    pre-0.15 framing with V4 metadata, each ndarray a Tensor message."""
    ndarrays: list[np.ndarray] = []
    root = _SeqBuilder(ndarrays)
    root.append(obj)
    column = root.finish("list")

    nodes, buffers = [], []
    column.flatten(nodes, buffers)
    body, spans = bytearray(), []
    for raw in buffers:
        spans.append((len(body), len(raw)))
        body += raw + bytes(-len(raw) % _IPC_ALIGN)
    batch = {0: ("i64", column.length),
             1: ("vector", np.asarray(nodes, "<i8").tobytes(), 8, len(nodes)),
             2: ("vector", np.asarray(spans, "<i8").tobytes(), 8, len(spans))}

    out = bytearray(struct.pack("<iii", 0, len(ndarrays), 0))
    out += bytes(-len(out) % _IPC_ALIGN)
    out += _frame(_message(_SCHEMA, {0: ("i16", 0), 1: ("tables", [column.field()])}, 0),
                  legacy=True)
    out += _frame(_message(_RECORD_BATCH, batch, len(body)), legacy=True) + body
    out += struct.pack("<i", 0)                      # end of stream
    for arr in ndarrays:
        out += bytes(-len(out) % _TENSOR_ALIGN)
        out += _tensor_message(arr)
    return bytes(out)
