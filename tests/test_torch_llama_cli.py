"""The LLaMA backbone and `--llm-weights` through the port's entry points on
the CPU (tiny config): `run_ted --llm-model LLAMA` trains 2 epochs and ends
bit for bit as 1 epoch + `--resume` does, on a fabricated bf16 sharded
checkpoint; `test_checkpoint --checkpoint-dir` and `restore_hop_model`
rebuild the LLaMA backbone from the run's metadata and reload its weights
(and refuse, with hop_tpu's message, when the path is gone); a resume with
another `--llm-weights`, or without it, is refused (ADVICE r5,
hop_tpu/cli/train_main.py:306: hop_tpu reattaches a random backbone); the
kernel attention routes are refused with LLaMA; `apply_overrides` gives
hop_tpu's LLaMA-7B config, and the thin one under `--tiny`."""

import contextlib
import dataclasses
import io
import json
import re
import shutil
import tempfile

import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.cli import common as JC

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli import common as C
from hop_tpu_torch.cli import run_ted, test_checkpoint
from hop_tpu_torch.models.llama import LlamaEncoder
from hop_tpu_torch.utils import safetensors_io
from hop_tpu_torch.utils.checkpoint import CheckpointManager, flat_entries

RUN = ["--device", "cpu", "--tiny", "--llm-model", "LLAMA", "--synthetic-videos", "1",
       "--batch-size", "13", "--warmup-epochs", "0", "--log-every", "1"]


def _quiet(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def write_llama_checkpoint(path, cfg, seed, n_layers=None):
    """An HF LLaMA checkpoint of a seeded LlamaEncoder at `cfg`'s geometry
    (`n_layers` deep): bf16, two safetensors shards, their
    `model.safetensors.index.json` and `config.json`. Returns the f32
    state dict it rounds."""
    path.mkdir()
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = LlamaEncoder(cfg).state_dict()
    half = cfg.n_layers // 2
    shards = {"model-00001-of-00002.safetensors":
              [k for k in sd if not k.startswith("layers.")
               or int(k.split(".")[1]) < half],
              "model-00002-of-00002.safetensors":
              [k for k in sd if k.startswith("layers.") and int(k.split(".")[1]) >= half]}
    for name, keys in shards.items():
        safetensors_io.write({"model." + k: sd[k].bfloat16() for k in keys},
                             str(path / name))
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {"model." + k: n for n, keys in shards.items()
                                        for k in keys}}))
    (path / "config.json").write_text(json.dumps(
        {"model_type": "llama", "num_hidden_layers": cfg.n_layers,
         "hidden_size": cfg.dim, "vocab_size": cfg.vocab_size}))
    return {k: v.bfloat16().float() for k, v in sd.items()}


@pytest.fixture
def llama_ckpt(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # MKL's threaded sums are not repeatable
    yield write_llama_checkpoint(tmp_path / "llama", tcfg.tiny_llama_llm_config(),
                                 seed=5, n_layers=3)
    torch.set_num_threads(threads)


def _run(tmp_path, ck, *extra):
    return _quiet(run_ted.main, RUN + ["--checkpoint-dir", str(tmp_path / ck),
                                       "--metrics", str(tmp_path / ck / "m.jsonl"),
                                       *extra])


def test_run_resumes_bitwise_and_restores_the_pretrained_llama(tmp_path, llama_ckpt):
    weights = str(tmp_path / "llama")
    (state, _), log = _run(tmp_path, "a", "--epochs", "2", "--llm-weights", weights)
    assert "loaded pretrained LLAMA backbone from" in log
    assert isinstance(state.model.llm_model, LlamaEncoder)
    for k, v in state.model.llm_model.state_dict().items():
        assert torch.equal(v, llama_ckpt[k]), k
    _run(tmp_path, "b", "--epochs", "1", "--llm-weights", weights)
    _, log = _run(tmp_path, "b", "--epochs", "2", "--llm-weights", weights, "--resume")
    assert "resumed from checkpoint epoch 0" in log
    a, b = (CheckpointManager(str(tmp_path / ck)) for ck in "ab")
    got, want = flat_entries(b.restore()), flat_entries(a.restore())
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v
               for k, v in want.items())
    assert (tmp_path / "a" / "m.jsonl").read_text() == (tmp_path / "b" / "m.jsonl").read_text()
    meta = a.run_metadata()
    assert (meta["llm_model"], meta["llm_layers"], meta["llm_dim"]) == ("LLAMA", 2, 64)
    assert meta["llm_weights"] == weights

    cfg, model, _ = C.restore_hop_model(tcfg.tiny_test_config("TED"), str(tmp_path / "a"),
                                        device="cpu")
    assert cfg.llm == tcfg.tiny_llama_llm_config(2)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    out, log = _quiet(test_checkpoint.main, ["--device", "cpu", "--tiny",
                                             "--clip-seconds", "2", "--vid", "0",
                                             "--checkpoint-dir", str(tmp_path / "a")])
    assert "loaded pretrained LLAMA backbone from" in log
    assert out.shape == (34, 27)

    shutil.rmtree(weights)
    with pytest.raises(SystemExit, match="which no longer exists"):
        C.restore_hop_model(tcfg.tiny_test_config("TED"), str(tmp_path / "a"), device="cpu")


@pytest.mark.parametrize("other", ["another", "none"])
def test_resume_refuses_another_or_missing_llm_weights(tmp_path, llama_ckpt, other):
    weights = str(tmp_path / "llama")
    _run(tmp_path, "ck", "--epochs", "1", "--llm-weights", weights)
    extra = []
    if other == "another":
        shutil.copytree(weights, tmp_path / "llama2")
        extra = ["--llm-weights", str(tmp_path / "llama2")]
    with pytest.raises(SystemExit, match=re.escape(f"llm_weights='{weights}'; this run "
                                                   "has llm_weights=")):
        _run(tmp_path, "ck", "--epochs", "2", "--resume", *extra)


def test_a_bert_resume_is_refused_on_a_llama_checkpoint(tmp_path):
    """A checkpoint whose metadata records the thin LLaMA is refused by a
    resume on the (default) BERT backbone, before anything is built."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    llama = tcfg.tiny_llama_llm_config()
    ckpt.metadata = {"seed": 2021, "llm_model": "LLAMA", "llm_layers": llama.n_layers,
                     "llm_dim": llama.dim}
    ckpt.save(0, {}, {"epoch": 0})
    argv = [a for a in RUN if a not in ("--llm-model", "LLAMA")]
    with pytest.raises(SystemExit, match="llm_model='LLAMA'.*this run has.*llm_model='BERT'"):
        _quiet(run_ted.main, argv + ["--checkpoint-dir", str(tmp_path / "ck"),
                                     "--metrics", str(tmp_path / "m.jsonl"),
                                     "--epochs", "2", "--resume"])


@pytest.mark.parametrize("route", ["fused", "block"])
def test_kernel_attention_routes_are_refused_with_llama(route):
    args = C.base_parser("port").parse_args(["--llm-model", "LLAMA",
                                             "--bert-attention", route])
    with pytest.raises(SystemExit, match=f"--bert-attention {route} with --llm-model "
                                         "LLAMA"):
        C.apply_overrides(tcfg.ted_config(), args)


@pytest.mark.parametrize("layers", [[], ["--llm-layers", "2"]], ids=["6", "2"])
def test_llama_overrides_match_jax(layers):
    """`--llm-model LLAMA` gives hop_tpu's llama7b_llm_config field by
    field (the port's attention route aside); with --tiny the thin LLaMA."""
    argv = ["--llm-model", "LLAMA"] + layers
    port = C.apply_overrides(tcfg.ted_config(), C.base_parser("p").parse_args(argv)).llm
    ref = JC.apply_overrides(jcfg.ted_config(), JC.base_parser("j").parse_args(argv)).llm
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    tiny = C.apply_overrides(tcfg.tiny_test_config("TED"),
                             C.base_parser("p").parse_args(argv + ["--tiny"])).llm
    assert tiny == tcfg.tiny_llama_llm_config(int(layers[1]) if layers else 2)
