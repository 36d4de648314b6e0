"""Flat mmap record store: the LMDB/pyarrow replacement (port of
hop_tpu/data/records.py, numpy only; the on-disk format is the same, so a
store written by either package reads in the other).

The reference stores one pyarrow-serialised blob per window in LMDB
(reference data_loader/data_preprocessor.py:168-174) and deserialises in
every DataLoader worker each epoch (lmdb_data_loader.py:118-124). Here the
offline preprocessor writes two files per split:

  <name>.bin — concatenated records; each record is a fixed-schema block of
               raw little-endian arrays followed by a JSON aux tail
  <name>.idx — (n_records + 1) int64 byte offsets

Readers mmap the .bin once and build zero-copy numpy views; the C++
batch gatherer (hop_tpu_torch/native, built with g++ at first use)
assembles whole batches into contiguous arrays in parallel, with a numpy
loop beside it; `RecordReader.native` says which one a reader uses. Fixed shapes mean the training input pipeline
does no per-sample parsing at all.
"""

from __future__ import annotations

import json
import mmap
import struct
import subprocess
from dataclasses import dataclass
from pathlib import Path
import numpy as np

MAGIC = b"HOPR0001"


@dataclass(frozen=True)
class RecordSchema:
    """Array fields of one window sample (extended-length, pre-clipping)."""
    n_frames_ext: int       # n_poses * 1.25 (lmdb_data_loader.py:91)
    n_joints: int
    n_bones: int
    audio_len: int          # n_frames_ext / fps * 16000
    spec_bins: int
    spec_len: int

    def fields(self):
        return (
            ("pose_seq", (self.n_frames_ext, self.n_joints, 3), np.float32),
            ("vec_seq", (self.n_frames_ext, self.n_bones, 3), np.float32),
            ("audio", (self.audio_len,), np.float32),
            ("spectrogram", (self.spec_bins, self.spec_len), np.float32),
        )

    @property
    def fixed_nbytes(self) -> int:
        return sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                   for _, shape, dt in self.fields())


def schema_for(n_poses: int, fps: int, n_joints: int, n_bones: int,
               spec_bins: int = 128) -> RecordSchema:
    n_ext = int(round(n_poses * 1.25))
    audio_len = int(n_ext / fps * 16000)
    spec_len = int(round((n_ext / fps * 16000 - 1024) / 512 + 1))
    return RecordSchema(n_ext, n_joints, n_bones, audio_len, spec_bins,
                        spec_len)


class RecordWriter:
    def __init__(self, path: str, schema: RecordSchema):
        self.path = Path(path)
        self.schema = schema
        self._bin = open(str(self.path) + ".bin", "wb")
        self._offsets = [0]
        self._bin.write(MAGIC)
        self._bin.write(struct.pack("<q", schema.fixed_nbytes))
        self._base = len(MAGIC) + 8
        self._pos = 0

    def append(self, pose_seq, vec_seq, audio, spectrogram, aux: dict):
        s = self.schema
        arrays = {"pose_seq": pose_seq, "vec_seq": vec_seq, "audio": audio,
                  "spectrogram": spectrogram}
        for name, shape, dt in s.fields():
            a = np.ascontiguousarray(arrays[name], dtype=dt)
            assert a.shape == shape, (name, a.shape, shape)
            self._bin.write(a.tobytes())
            self._pos += a.nbytes
        tail = json.dumps(aux).encode("utf-8")
        self._bin.write(struct.pack("<q", len(tail)))
        self._bin.write(tail)
        self._pos += 8 + len(tail)
        self._offsets.append(self._pos)

    def close(self):
        self._bin.close()
        np.asarray(self._offsets, dtype=np.int64).tofile(
            str(self.path) + ".idx")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Zero-copy mmap reader. With `use_native`, batches come from the C++
    gatherer when it builds and loads (`native` is then True), else from
    the numpy loop."""

    def __init__(self, path: str, schema: RecordSchema,
                 use_native: bool = True):
        self.path = Path(path)
        self.schema = schema
        self._file = open(str(self.path) + ".bin", "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        assert self._mm[:8] == MAGIC, "bad record file magic"
        (fixed,) = struct.unpack("<q", self._mm[8:16])
        assert fixed == schema.fixed_nbytes, (fixed, schema.fixed_nbytes)
        self._base = 16
        self.offsets = np.fromfile(str(self.path) + ".idx", dtype=np.int64)
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        self._native = None
        if use_native:
            from hop_tpu_torch.native import recordstore
            try:
                recordstore.load()
                self._native = recordstore
            except (OSError, subprocess.SubprocessError):
                self._native = None

    @property
    def native(self) -> bool:
        """True when `gather` runs the C++ gatherer."""
        return self._native is not None

    def __len__(self):
        return len(self.offsets) - 1

    def _record_view(self, idx: int):
        start = self._base + int(self.offsets[idx])
        out = {}
        pos = start
        for name, shape, dt in self.schema.fields():
            n = int(np.prod(shape)) * np.dtype(dt).itemsize
            out[name] = np.frombuffer(self._mm, dtype=dt, count=int(np.prod(shape)),
                                      offset=pos).reshape(shape)
            pos += n
        (tail_len,) = struct.unpack("<q", self._mm[pos:pos + 8])
        aux = json.loads(self._mm[pos + 8: pos + 8 + tail_len])
        return out, aux

    def __getitem__(self, idx: int):
        return self._record_view(idx)

    def aux(self, idx: int) -> dict:
        return self._record_view(idx)[1]

    def gather(self, indices: np.ndarray) -> dict:
        """Assemble a batch of the fixed-shape fields: (B, ...) arrays.

        The C++ parallel gatherer when `native`, else a numpy loop over
        zero-copy views; the two give the same bytes.
        """
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size and (indices.min() < 0 or indices.max() >= len(self)):
            raise IndexError(f"record indices outside [0, {len(self)})")
        s = self.schema
        if self._native is not None:
            return self._native.gather(self._buf, self.offsets, indices,
                                       self._base, s)
        batch = {name: np.empty((len(indices),) + shape, dt)
                 for name, shape, dt in s.fields()}
        for bi, idx in enumerate(indices):
            rec, _ = self._record_view(int(idx))
            for name in batch:
                batch[name][bi] = rec[name]
        return batch

    def close(self):
        self._mm.close()
        self._file.close()
