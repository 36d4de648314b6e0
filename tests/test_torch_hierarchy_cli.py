"""The hierarchy and the FGD feature net's loop through the port's entry
points on the CPU, at the tiny size:

  * `run_ted --model hierarchy` (3 stages) and `run_expressive --model
    hierarchy` (6 stages), the full-depth ResNetSE, on the records of one
    seeded 6 s clip, train one epoch of one step, validate with FGD and
    save; a run resumed from it to a second epoch ends bit for bit where an
    uninterrupted two-epoch run does (torch on one thread: MKL's threaded
    products are not repeatable from call to call);
  * `data.h36m.Human36M`'s windows equal hop_tpu's, with and without the
    noise augmentation (its draws in the same order), to 1e-6 (the dir-vec
    conversions run in f32 on both sides, by other kernels);
  * `cli.train_h36m_ae` trains two epochs at bs 8 on a fabricated
    `positions_3d` npz (tests/test_h36m_ae.py's), `eval.export_eval_net`
    writes its `--eval-net`, and hop_tpu's and the port's
    `make_fgd_evaluator` both read it as a trained net and give the same
    features and reconstructions to 1e-5 of their largest element.
"""

import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from hop_tpu.cli.common import make_fgd_evaluator as jax_make_fgd_evaluator
from hop_tpu.config import ted_config as jax_ted_config
from hop_tpu.data.h36m import Human36M as JaxHuman36M
from hop_tpu import geometry as jgeometry

from hop_tpu_torch.cli import run_expressive, run_ted, train_h36m_ae
from hop_tpu_torch.cli.common import make_fgd_evaluator
from hop_tpu_torch.config import ted_config, tiny_test_config
from hop_tpu_torch.data import synthetic
from hop_tpu_torch.data.h36m import Human36M
from hop_tpu_torch.data.preprocessor import DataPreprocessor
from hop_tpu_torch.eval.export_eval_net import export
from hop_tpu_torch.models.hierarchy import HierarchyNet
from hop_tpu_torch.utils.checkpoint import CheckpointManager, differing_entries
from hop_tpu_torch import geometry

from test_h36m_ae import _fake_h36m_npz
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

TINY_RUN = ["--device", "cpu", "--tiny", "--batch-size", "64", "--warmup-epochs", "0",
            "--log-every", "1", "--model", "hierarchy"]
CLIP_SECONDS = 6.0      # 5 windows: one step an epoch


def clip_records(directory, dataset):
    """The records of one seeded CLIP_SECONDS clip at the tiny config, as
    both splits: the flags that point a run at them."""
    cfg = tiny_test_config(dataset)
    videos = synthetic.make_source_clips(cfg, n_videos=1, clip_seconds=CLIP_SECONDS, seed=0)
    for split in ("train", "val"):
        DataPreprocessor(cfg.data, os.path.join(directory, split)).run(videos)
    return ["--data", os.path.join(directory, "train"),
            "--val-data", os.path.join(directory, "val")]


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def _run(entry, directory, epochs, *extra):
    return _quiet(entry.main, TINY_RUN + ["--checkpoint-dir", str(directory / "ck"),
                                          "--metrics", str(directory / "m.jsonl"),
                                          "--epochs", str(epochs), *extra])


@pytest.mark.parametrize("entry,dataset,stages", [(run_ted, "TED", 3),
                                                  (run_expressive, "TED_expressive", 6)],
                         ids=["run_ted", "run_expressive"])
def test_hierarchy_trains_validates_saves_and_resumes_bitwise(monkeypatch, tmp_path, entry,
                                                             dataset, stages):
    """Two epochs straight, and one epoch resumed to two: the same state."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (tmp_path / "records").mkdir()
    data = clip_records(tmp_path / "records", dataset)
    (state, _), log = _run(entry, tmp_path / "whole", 2, *data)
    assert isinstance(state.model, HierarchyNet) and len(state.model.stages) == stages
    assert state.step == 2 and "[VAL] loss:" in log and "Saved the checkpoint" in log
    meta = json.loads((tmp_path / "whole" / "ck" / "run_metadata.json").read_text())
    assert meta["model"] == "hierarchy" and meta["dataset"] == dataset
    _run(entry, tmp_path / "split", 1, *data)
    (state, _), log = _run(entry, tmp_path / "split", 2, "--resume", *data)
    assert "resumed from checkpoint epoch 0" in log and state.step == 2
    whole = CheckpointManager(str(tmp_path / "whole" / "ck")).restore(1)
    split = CheckpointManager(str(tmp_path / "split" / "ck")).restore(1)
    assert differing_entries(whole, split) == []
    assert all(f"{name}: " in log for name in ("c_pos", "c_neg", "phy", "gen", "dis"))
    lines = [json.loads(line) for line in (tmp_path / "split" / "m.jsonl").read_text()
             .splitlines()]
    assert all(np.isfinite(line["value"]) for line in lines)


def _positions():
    r = np.random.default_rng(0)
    positions = {}
    for subject in ("S1", "S9"):
        positions[subject] = {
            f"act{a}": (r.standard_normal((1, 32, 3)) * 0.2
                        + np.cumsum(r.standard_normal((200, 32, 3)) * 0.003, axis=0)
                        ).astype(np.float32) for a in range(2)}
    return positions


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_human36m_windows_match_jax(augment):
    positions = _positions()
    port = Human36M(positions, geometry.TED_SKELETON.mean_dir_vec, augment=augment, seed=3)
    ref = JaxHuman36M(positions, jgeometry.TED_SKELETON.mean_dir_vec, augment=augment,
                      seed=3)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        for got, want in zip(port[i], ref[i]):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    test = Human36M(positions, geometry.TED_SKELETON.mean_dir_vec, is_train=False)
    assert len(test) == len(JaxHuman36M(positions, jgeometry.TED_SKELETON.mean_dir_vec,
                                        is_train=False))


def test_train_h36m_ae_export_and_both_evaluators(tmp_path):
    npz = str(tmp_path / "h36m.npz")
    _fake_h36m_npz(npz, np.random.default_rng(0))
    ck = tmp_path / "ck"
    rc, log = _quiet(train_h36m_ae.main, ["--npz", npz, "--checkpoint-dir", str(ck),
                                          "--epochs", "2", "--batch-size", "8",
                                          "--device", "cpu"])
    assert rc == 0 and "epoch 2:" in log and "saved" in log
    out = str(tmp_path / "evalnet.npz")
    export(str(ck), out)
    with np.load(out) as data:
        assert all(k.startswith(("params/", "batch_stats/")) for k in data.files)
    port = make_fgd_evaluator(ted_config(), 4, out, "cpu")
    ref = jax_make_fgd_evaluator(jax_ted_config(), 4, out)
    assert port.trained and ref.trained
    poses = np.random.default_rng(1).normal(0, 0.2, (5, 34, 27)).astype(np.float32)
    got = port._feature_fn(torch.tensor(poses))
    want = ref._feature_fn(poses)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_export_refuses_another_family(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.metadata = {"model": "hierarchy"}
    ckpt.save(0, {"gen": {}})
    with pytest.raises(SystemExit, match="'hierarchy' run"):
        export(str(tmp_path / "ck"), str(tmp_path / "x.npz"))
