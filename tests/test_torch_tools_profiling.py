"""The port's copies of hop_tpu.utils.tools and hop_tpu.utils.profiling's
StepTimer against the originals, exactly (pure Python on the same inputs),
and its torch.profiler trace (`utils.profiling.trace`, and the training
loop's --profile-dir through the same helpers)."""

import json
import os

import numpy as np
import pytest
import torch

from hop_tpu.utils import profiling as jprofiling
from hop_tpu.utils import tools as jtools

from hop_tpu_torch.cli import run_ted
from hop_tpu_torch.utils import profiling, tools
from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)

LRADJ = ["type1", "type2", "COS", "constant"]


@pytest.mark.parametrize("lradj", LRADJ)
def test_adjust_learning_rate_is_hop_tpus(lradj):
    for base in (1e-4, 5e-4, 0.01):
        for train_epochs in (10, 75):
            got = [tools.adjust_learning_rate(e, base, lradj, train_epochs) for e in range(81)]
            want = [jtools.adjust_learning_rate(e, base, lradj, train_epochs)
                    for e in range(81)]
            assert got == want


@pytest.mark.parametrize("patience,delta", [(1, 0.0), (3, 0.0), (3, 0.05), (7, 0.01)])
def test_early_stopping_is_hop_tpus(patience, delta, capsys):
    r = np.random.default_rng(patience)
    losses = list(np.cumsum(r.normal(-0.02, 0.1, 40)) + 3.0)
    saved = {"port": [], "jax": []}
    port = tools.EarlyStopping(patience, True, delta,
                               save_fn=lambda s, p: saved["port"].append((s, p)))
    jax_ = jtools.EarlyStopping(patience, True, delta,
                                save_fn=lambda s, p: saved["jax"].append((s, p)))
    for i, loss in enumerate(losses):
        assert port(loss, state=i, path=f"p{i}") == jax_(loss, state=i, path=f"p{i}")
        assert (port.counter, port.best_score, port.val_loss_min, port.early_stop) == (
            jax_.counter, jax_.best_score, jax_.val_loss_min, jax_.early_stop)
    assert saved["port"] == saved["jax"] and saved["port"]
    out = capsys.readouterr().out.splitlines()
    assert out[0::2] == out[1::2]          # the same messages, each twice


def test_scaler_dotdict_accuracy_del_files(tmp_path):
    x = np.random.default_rng(0).normal(3, 2, (5, 4))
    mean, std = x.mean(0), x.std(0)
    a, b = tools.StandardScaler(mean, std), jtools.StandardScaler(mean, std)
    np.testing.assert_array_equal(a.transform(x), b.transform(x))
    np.testing.assert_array_equal(a.inverse_transform(a.transform(x)),
                                  b.inverse_transform(b.transform(x)))
    d = tools.dotdict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2 and d.missing is None
    del d.a
    assert dict(d) == dict(jtools.dotdict(b=2))
    y, z = np.array([1, 2, 3, 3]), np.array([1, 0, 3, 2])
    assert tools.cal_accuracy(y, z) == jtools.cal_accuracy(y, z) == 0.5
    (tmp_path / "d" / "e").mkdir(parents=True)
    tools.del_files(str(tmp_path / "d"))
    assert not (tmp_path / "d").exists()


def test_step_timer_summary_is_hop_tpus():
    durations = list(np.random.default_rng(1).uniform(0.01, 0.2, 37))
    port, jax_ = profiling.StepTimer(), jprofiling.StepTimer()
    assert port.summary() == jax_.summary() == {}
    port.durations, jax_.durations = list(durations), list(durations)
    assert port.summary() == jax_.summary()
    assert set(port.summary()) == {"mean_s", "p50_s", "p95_s", "steps_per_sec"}
    with port.step():
        pass
    assert len(port.durations) == 38 and port.durations[-1] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_profile_dir_of_a_training_run(tmp_path, monkeypatch, capsys):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run_ted.main(["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
                  "--warmup-epochs", "0", "--epochs", "1", "--checkpoint-dir",
                  str(tmp_path / "ck"), "--metrics", str(tmp_path / "m.jsonl"),
                  "--profile-dir", str(tmp_path / "prof")])
    assert f"profile trace written to {tmp_path / 'prof'}" in capsys.readouterr().out
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
