"""ctypes binding for the C++ record-store batch gatherer (port of
hop_tpu/native/recordstore.py).

`load()` compiles `recordstore.cc` with g++ (120 s limit) the first time,
into `build/native/` at the repository root or `$HOP_TPU_TORCH_NATIVE_DIR`,
under a name that carries a hash of the source and the flags, and loads
it; it raises when g++ is missing or fails. The compile writes a temporary
file and renames it, so processes that build at once do not see each
other's half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "recordstore.cc"
FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None


def _build_dir() -> Path:
    env = os.environ.get("HOP_TPU_TORCH_NATIVE_DIR")
    return Path(env) if env else SRC.parent.parent.parent / "build" / "native"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return _build_dir() / f"librecordstore_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The gatherer's library, built first if it is not there yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
                           check=True, capture_output=True, timeout=BUILD_TIMEOUT_S)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.gather_records.argtypes = [
            ctypes.c_void_p,                       # base
            ctypes.POINTER(ctypes.c_int64),        # offsets
            ctypes.POINTER(ctypes.c_int64),        # indices
            ctypes.c_int64,                        # n_indices
            ctypes.c_int64,                        # header_bytes
            ctypes.POINTER(ctypes.c_int64),        # field_sizes
            ctypes.c_int32,                        # n_fields
            ctypes.POINTER(ctypes.c_void_p),       # out_ptrs
            ctypes.c_int32,                        # n_threads
        ]
        lib.gather_records.restype = None
        _lib = lib
        return lib


def gather(buf: np.ndarray, offsets: np.ndarray, indices: np.ndarray,
           header_bytes: int, schema, n_threads: int | None = None) -> dict:
    """Gather `indices` into contiguous per-field batch arrays."""
    lib = load()
    n_threads = n_threads or min(8, os.cpu_count() or 1)
    fields = schema.fields()
    sizes = np.asarray(
        [int(np.prod(shape)) * np.dtype(dt).itemsize
         for _, shape, dt in fields], dtype=np.int64)
    outs = {name: np.empty((len(indices),) + shape, dt)
            for name, shape, dt in fields}
    out_ptrs = (ctypes.c_void_p * len(fields))(
        *[outs[name].ctypes.data for name, _, _ in fields])
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    lib.gather_records(
        buf.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices), header_bytes,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(fields), out_ptrs, n_threads)
    return outs
