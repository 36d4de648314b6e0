"""Metric-stream adapters: JSONL -> TensorBoard / CSV (port of
hop_tpu/utils/metrics_export.py).

The training loop writes scalars as JSONL (`train.loops.MetricWriter`),
in place of the reference's SummaryWriter (run_ted.py:216-217, 449-451).
This module bridges back to the reference's tooling:

- `export_tensorboard`: a JSONL file into a TensorBoard event directory,
  with the loop's tag names (`diversity_score/val`, `val_frechet_dist/val`,
  `BC/val`, ...).
- `export_csv`: one wide CSV (step x metric) for spreadsheets.
- `TensorBoardMirror`: the live writer the loop attaches under
  `--tensorboard-dir`.

The event file is written here, not through `torch.utils.tensorboard`
(which needs the `tensorboard` package): TFRecord framing (length, masked
CRC-32C of the length, the record, masked CRC-32C of the record) around
hand-encoded `Event` protobufs, a `file_version` event first and then one
`Event{wall_time, step, summary{value{tag, simple_value}}}` a scalar, as
SummaryWriter.add_scalar writes it (simple_value is an f32).

CLI:  python -m hop_tpu_torch.utils.metrics_export --jsonl m.jsonl \
          --to tensorboard --out runs/exp1
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import socket
import struct
import time
from collections import defaultdict


def read_jsonl(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotated right by 15 bits, plus 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: uint64 length, its masked CRC, the data, its masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1           # int64 two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """Event{wall_time: 1, step: 2, summary: 5 {value: 1 {tag: 1,
    simple_value: 2 (f32)}}} as protobuf bytes."""
    val = _field_bytes(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
    summary = _field_bytes(1, val)
    return (b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(step)
            + _field_bytes(5, summary))


def version_event(wall_time: float) -> bytes:
    """Event{wall_time: 1, file_version: 3 = "brain.Event:2"}."""
    return b"\x09" + struct.pack("<d", wall_time) + _field_bytes(3, b"brain.Event:2")


class TensorBoardMirror:
    """Live add_scalar mirror into an event file of its own in `logdir`
    (`events.out.tfevents.<time>.<host>.<pid>`), flushed at every scalar so
    a reader sees the rows as they come."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(logdir, f"events.out.tfevents.{int(now):010d}."
                                         f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(self.path, "wb")
        self._f.write(tfrecord(version_event(now)))
        self._f.flush()

    def scalar(self, name: str, value: float, step: int):
        self._f.write(tfrecord(scalar_event(name, float(value), int(step), time.time())))
        self._f.flush()

    def close(self):
        self._f.close()


def export_tensorboard(jsonl_path: str, logdir: str) -> int:
    mirror = TensorBoardMirror(logdir)
    n = 0
    for row in read_jsonl(jsonl_path):
        mirror.scalar(row["name"], row["value"], row["step"])
        n += 1
    mirror.close()
    return n


def export_csv(jsonl_path: str, out_path: str) -> int:
    by_step: dict[int, dict] = defaultdict(dict)
    names = []
    for row in read_jsonl(jsonl_path):
        by_step[row["step"]][row["name"]] = row["value"]
        if row["name"] not in names:
            names.append(row["name"])
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step"] + names)
        for step in sorted(by_step):
            w.writerow([step] + [by_step[step].get(n, "") for n in names])
    return len(by_step)


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--jsonl", required=True)
    p.add_argument("--to", default="tensorboard",
                   choices=("tensorboard", "csv"))
    p.add_argument("--out", required=True,
                   help="event dir (tensorboard) or .csv path")
    args = p.parse_args(argv)
    if args.to == "tensorboard":
        n = export_tensorboard(args.jsonl, args.out)
    else:
        n = export_csv(args.jsonl, args.out)
    print(f"exported {n} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
