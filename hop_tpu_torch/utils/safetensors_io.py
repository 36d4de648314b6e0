"""The safetensors file format, read and written without the `safetensors`
package (the machine with the card has neither it nor `transformers`).

A file is an 8-byte little-endian header length N, then N bytes of JSON,
`{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin, end]}, ...}`
with an optional `"__metadata__"` map of strings, then the tensors' raw
little-endian bytes, each [begin, end) counted from the end of the header.

`read` maps the file and makes tensors only of the names asked for, each a
view of the map (pages are read when touched; the map stays open while a
tensor refers to it); a tensor whose bytes are not aligned to its element
size is copied. BF16 goes through `torch.frombuffer(..., dtype=torch.
bfloat16)`, never through numpy, which has no bfloat16. `write` is the
small writer the tests and `chip_smoke.py` fabricate checkpoints with: the
header padded with spaces to a multiple of 8 bytes, the tensors in the
order given, end to end.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Iterable, Optional

import torch

#: the format's dtype names
DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def _parse_header(raw: bytes, path: str) -> tuple:
    """(header, bytes before the first tensor) from the file's first bytes."""
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes in a {len(raw)}-byte file")
    return json.loads(raw[8:8 + n]), 8 + n


def read(path: str, names: Optional[Iterable[str]] = None) -> dict:
    """{name: tensor} of `names` (default: every tensor in the file), each
    a view of a map of the file. Raises KeyError on a name the file lacks
    and ValueError on a dtype this reader does not know."""
    with open(path, "rb") as f:
        # a private, copy-on-write map: tensors may be written to without
        # touching the file (torch.frombuffer wants a writable buffer)
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    size = len(data)
    header, start = _parse_header(data, path)
    header.pop("__metadata__", None)
    wanted = list(header) if names is None else list(names)
    out = {}
    for name in wanted:
        entry = header[name]
        if entry["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {entry['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        dtype = DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        begin, end = (start + o for o in entry["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        if count * itemsize != end - begin or end > size or count != _numel(shape):
            raise ValueError(f"{path}: tensor {name} of {shape} {entry['dtype']} "
                             f"has bytes [{begin}, {end}) of a {size}-byte file")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif begin % itemsize == 0:
            out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                         offset=begin).reshape(shape)
        else:
            raw = torch.frombuffer(data, dtype=torch.uint8, count=end - begin,
                                   offset=begin).clone()
            out[name] = raw.view(dtype).reshape(shape)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def write(tensors: dict, path: str) -> None:
    """Write `tensors` ({name: tensor} on any device, any of `DTYPES`) to a
    safetensors file at `path`, in the order given."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors name")
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
        blobs.append(t)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-(8 + len(text)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
