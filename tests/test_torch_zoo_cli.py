"""The baseline zoo through the port's training entry points on the CPU, at
the tiny size: `run_ted --model X` trains one epoch of one step (training,
validation with FGD, the checkpoint) for each of the five ported families
and resumes it to a second epoch; `run_expressive` does the same for the
trimodal GAN and for gesture_autoencoder, which trains the MotionAE at
pose_dim 126 (`--model hierarchy` is test_torch_hierarchy_cli.py's); a
checkpoint of one family is refused by a resume as another, before anything
is built (hop_tpu records the family and does not check it)."""

import contextlib
import io
import json
import tempfile

import pytest
import torch

from hop_tpu_torch.cli import run_expressive, run_ted, test_checkpoint, train_main
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.train.state import GANTrainState, SimpleTrainState

from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

# one step an epoch: a batch larger than the one synthetic video's windows
TINY_RUN = ["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "64",
            "--warmup-epochs", "0", "--log-every", "1"]
FAMILIES = [("multimodal_context", GANTrainState), ("seq2seq", SimpleTrainState),
            ("speech2gesture", GANTrainState), ("joint_embedding", SimpleTrainState),
            ("gesture_autoencoder", SimpleTrainState)]


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def _run(entry, tmp_path, model, epochs, *extra):
    argv = TINY_RUN + ["--model", model, "--checkpoint-dir", str(tmp_path / "ck"),
                       "--metrics", str(tmp_path / "m.jsonl"), "--epochs", str(epochs),
                       *extra]
    return _quiet(entry.main, argv)


@pytest.mark.parametrize("model,state_kind", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_run_ted_trains_validates_saves_and_resumes(monkeypatch, tmp_path, model,
                                                    state_kind):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (state, best), log = _run(run_ted, tmp_path, model, 1)
    assert isinstance(state, state_kind) and state.step == 1
    assert "[VAL] loss:" in log and "Saved the checkpoint" in log
    meta = json.loads((tmp_path / "ck" / "run_metadata.json").read_text())
    assert meta["model"] == model and meta["dataset"] == "TED" and meta["epoch"] == 0
    (state, _), log = _run(run_ted, tmp_path, model, 2, "--resume")
    assert "resumed from checkpoint epoch 0" in log
    assert state.step == 2
    lines = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert {line["step"] for line in lines} == {0, 1}
    assert all(torch.isfinite(torch.tensor(line["value"])) for line in lines)


@pytest.mark.parametrize("model", ["multimodal_context", "gesture_autoencoder"])
def test_run_expressive_trains_the_zoo(monkeypatch, tmp_path, model):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (state, _), log = _run(run_expressive, tmp_path, model, 1)
    assert "[VAL] loss:" in log and state.step == 1
    if model == "gesture_autoencoder":
        assert isinstance(state.model, MotionAE)
    else:
        assert state.model.out[-1].out_features == 126
    assert json.loads((tmp_path / "ck" / "run_metadata.json").read_text())[
        "dataset"] == "TED_expressive"


def test_resume_refuses_another_family(monkeypatch, tmp_path):
    """A HOP (AD_LLM) checkpoint resumed as seq2seq is refused, naming both
    families, before the datasets or any net are built."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _run(run_ted, tmp_path, "AD_LLM", 1)
    built = []
    monkeypatch.setattr(train_main.C, "load_datasets", lambda *a: built.append(1))
    with pytest.raises(SystemExit, match="model='AD_LLM'.*this run has.*model='seq2seq'"):
        _run(run_ted, tmp_path, "seq2seq", 2, "--resume")
    assert not built


def test_test_checkpoint_refuses_a_zoo_checkpoint(monkeypatch, tmp_path):
    """The long-form generator restores HOP; a seq2seq checkpoint is refused
    by name, not loaded into the wrong net."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _run(run_ted, tmp_path, "seq2seq", 1)
    with pytest.raises(SystemExit, match="holds a seq2seq checkpoint"):
        _quiet(test_checkpoint.main, ["--device", "cpu", "--tiny", "--clip-seconds", "2",
                                      "--checkpoint-dir", str(tmp_path / "ck")])
