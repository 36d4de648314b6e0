"""The port's metric export (hop_tpu_torch.utils.metrics_export) against
hop_tpu.utils.metrics_export, and `run_ted --tensorboard-dir`.

The CSV is byte-equal to hop_tpu's. The port writes TensorBoard event files
itself (no `tensorboard` package on the card's machine); here the
`tensorboard` package's own reader (EventAccumulator, which checks the
records' CRCs) reads them, and they hold the same (tag, step, value in f32)
rows as the file hop_tpu writes through torch's SummaryWriter. The CRC-32C
is held to the RFC 3720 vectors and to tensorboard's masked CRC.
"""

import json
import os

import numpy as np
import pytest

from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboard.compat.tensorflow_stub import pywrap_tensorflow as tb_crc

from hop_tpu.utils import metrics_export as jexport

from hop_tpu_torch.cli import run_expressive, run_ted
from hop_tpu_torch.train.loops import MetricWriter
from hop_tpu_torch.utils import metrics_export as export
from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)


def _write_stream(path):
    r = np.random.default_rng(0)
    w = MetricWriter(str(path))
    for e in range(4):
        w.scalar("val_frechet_dist/val", float(r.normal(10, 3)), e)
        w.scalar("BC/val", 0.1 * e + 1e-9, e)
        w.scalar("diversity_score/val", float(r.uniform()), e)
    w.scalar("loss/val", -2.5, -1)
    w.close()


def read_scalars(logdir: str) -> list:
    """(tag, step, value) of every scalar, in tag then step order."""
    acc = EventAccumulator(logdir, size_guidance={"scalars": 0})
    acc.Reload()
    return sorted((tag, e.step, e.value) for tag in acc.Tags()["scalars"]
                  for e in acc.Scalars(tag))


def test_csv_is_hop_tpus(tmp_path):
    _write_stream(tmp_path / "m.jsonl")
    assert export.export_csv(str(tmp_path / "m.jsonl"), str(tmp_path / "a.csv")) == 5
    assert jexport.export_csv(str(tmp_path / "m.jsonl"), str(tmp_path / "b.csv")) == 5
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


def test_event_file_holds_hop_tpus_rows(tmp_path):
    _write_stream(tmp_path / "m.jsonl")
    assert export.export_tensorboard(str(tmp_path / "m.jsonl"), str(tmp_path / "port")) == 13
    assert jexport.export_tensorboard(str(tmp_path / "m.jsonl"), str(tmp_path / "jax")) == 13
    got, want = read_scalars(str(tmp_path / "port")), read_scalars(str(tmp_path / "jax"))
    assert len(got) == 13 and got == want
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert got == sorted((r["name"], r["step"], float(np.float32(r["value"]))) for r in rows)


@pytest.mark.parametrize("data", [b"", b"123456789", bytes(32), b"\xff" * 32,
                                  bytes(range(32))])
def test_crc32c_known_vectors(data):
    want = {b"": 0, b"123456789": 0xE3069283, bytes(32): 0x8A9136AA,
            b"\xff" * 32: 0x62A8AB43, bytes(range(32)): 0x46DD794E}[data]
    assert export.crc32c(data) == want
    assert export.masked_crc32c(data) == tb_crc.masked_crc32c(data)


def test_cli_writes_csv_and_events(tmp_path, capsys):
    _write_stream(tmp_path / "m.jsonl")
    export.main(["--jsonl", str(tmp_path / "m.jsonl"), "--to", "csv",
                 "--out", str(tmp_path / "m.csv")])
    export.main(["--jsonl", str(tmp_path / "m.jsonl"), "--out", str(tmp_path / "tb")])
    out = capsys.readouterr().out
    assert "exported 5 rows" in out and "exported 13 rows" in out
    assert len(read_scalars(str(tmp_path / "tb"))) == 13


@pytest.mark.parametrize("entry", [run_ted, run_expressive], ids=["ted", "expressive"])
def test_tensorboard_dir_mirrors_the_run(tmp_path, monkeypatch, entry):
    """--tensorboard-dir (once refused as not ported) mirrors every row of
    --metrics into an event file as the run writes it."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    entry.main(["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
                "--warmup-epochs", "0", "--epochs", "2", "--checkpoint-dir",
                str(tmp_path / "ck"), "--metrics", str(tmp_path / "m.jsonl"),
                "--tensorboard-dir", str(tmp_path / "tb")])
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert len(rows) == 8
    assert len([f for f in os.listdir(tmp_path / "tb") if "tfevents" in f]) == 1
    assert read_scalars(str(tmp_path / "tb")) == sorted(
        (r["name"], r["step"], float(np.float32(r["value"]))) for r in rows)
