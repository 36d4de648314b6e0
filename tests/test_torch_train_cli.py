"""The port's training entry points (hop_tpu_torch.cli.run_ted, train_main,
common.base_parser / apply_overrides) against hop_tpu's, on the CPU.

For the same argv both packages' `base_parser` give the same value for
every flag they share, and `apply_overrides` gives configs equal field by
field (the port's own fields: its routes). The port's parser has every
flag of hop_tpu's; a parallel flag that asks for more than one rank outside
torchrun's environment exits with the torchrun command line (the port spawns
no workers of its own); `--llm-model LLAMA` and `--llm-weights` reach the
model on both entries. A resume whose seed differs from the
checkpoint's is refused: the frozen backbone is rebuilt from the seed
(ADVICE r5, hop_tpu/cli/train_main.py:306).
"""

import contextlib
import dataclasses
import io
import tempfile

import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.cli import common as JC

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli import common as C
from hop_tpu_torch.cli import run_expressive, run_ted, test_checkpoint, train_main
from hop_tpu_torch.models.bert import BertEncoder
from hop_tpu_torch.models.llama import LlamaEncoder
from hop_tpu_torch.utils import safetensors_io
from hop_tpu_torch.utils.checkpoint import CheckpointManager

# the port's own flags and config fields
PORT_FLAGS = {"device", "tiny", "gru_kernel", "bert_attention", "dist_backend"}
PORT_FIELDS = {"hop": {"gru_kernel", "gru_bf16_streams"}, "llm": {"attention"}}

ARGVS = [
    [],
    ["--epochs", "3", "--batch-size", "8", "--learning-rate", "0.002",
     "--warmup-epochs", "0", "--seed", "7", "--prefetch", "2", "--log-every", "5"],
    ["--parity-step", "--audio-wire", "int16", "--llm-layers", "3",
     "--use-hf-token-stream", "--hf-vocab", "v.txt", "--transfer-guard", "disallow",
     "--resume", "--checkpoint-every", "2", "--profile-dir", "/tmp/p"],
]
TINY_RUN = ["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
            "--warmup-epochs", "0", "--log-every", "1"]


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "run", "routes"])
def test_parser_defaults_match_jax(argv):
    port = vars(C.base_parser("port").parse_args(argv))
    ref = vars(JC.base_parser("jax").parse_args(argv))
    assert set(port) - set(ref) == PORT_FLAGS
    assert set(ref) <= set(port)
    for k in ref:
        assert port[k] == ref[k], k
    assert port["device"] == "cuda"


@pytest.mark.parametrize("preset", ["ted", "expressive", "tiny"])
@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "run", "routes"])
def test_apply_overrides_match_jax(preset, argv):
    make = {"ted": lambda m: m.ted_config(), "expressive": lambda m: m.expressive_config(),
            "tiny": lambda m: m.tiny_test_config("TED")}[preset]
    port = C.apply_overrides(make(tcfg), C.base_parser("port").parse_args(argv))
    ref = JC.apply_overrides(make(jcfg), JC.base_parser("jax").parse_args(argv))
    for section in ("data", "llm", "hop", "baseline", "loss", "train"):
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            if f.name not in PORT_FIELDS.get(section, ()):
                assert getattr(p, f.name) == getattr(r, f.name), f"{section}.{f.name}"


def test_routes_reach_the_config():
    args = C.base_parser("port").parse_args(["--gru-kernel", "stack",
                                             "--bert-attention", "block"])
    cfg = C.apply_overrides(tcfg.ted_config(), args)
    assert cfg.hop.gru_kernel == "stack" and cfg.llm.attention == "block"


#: the parallel flags (ROADMAP M15): each asks for more than one rank
UNPORTED = [
    (["--data-parallel", "2"], "torch.distributed.run"),
    (["--model-parallel", "2"], "torch.distributed.run"),
    (["--dcn-slices", "2"], "torch.distributed.run"),
    (["--data-parallel", "2", "--no-zero2"], "torch.distributed.run"),
]


@pytest.mark.parametrize("argv,item", UNPORTED, ids=[a[0] for a, _ in UNPORTED])
@pytest.mark.parametrize("entry", [run_ted, run_expressive], ids=["ted", "expressive"])
def test_unported_flags_exit_naming_their_roadmap_item(monkeypatch, tmp_path, entry,
                                                       argv, item):
    """Once refused as not ported; now a request for ranks without torchrun's
    environment exits with the torchrun command line, before anything is
    built."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(SystemExit, match=item):
        _quiet(entry.main, TINY_RUN + ["--checkpoint-dir", str(tmp_path / "ck"),
                                       "--metrics", str(tmp_path / "m.jsonl"),
                                       "--epochs", "1"] + argv)


def _tiny_bert_checkpoint(path):
    """An HF-named state dict of the tiny config's BERT, seeded, as
    model.safetensors in the directory `path`."""
    path.mkdir()
    llm = tcfg.tiny_test_config("TED").llm
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        sd = BertEncoder(llm).state_dict()
    safetensors_io.write(sd, str(path / "model.safetensors"))
    return sd


@pytest.mark.parametrize("flag", ["llm_model", "llm_weights"])
@pytest.mark.parametrize("entry", [run_ted, run_expressive], ids=["ted", "expressive"])
def test_backbone_flags_are_accepted(monkeypatch, tmp_path, entry, flag):
    """--llm-model LLAMA and --llm-weights (once refused as not ported)
    reach the model both entries train: a LLaMA backbone, or the
    checkpoint's arrays in the backbone; the run's metadata records them."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = {}

    def run_training(cfg, batches, warmup, gan, state, **kw):
        seen["state"] = state
        return state, 0.0
    monkeypatch.setattr(train_main, "run_training", run_training)
    ck = tmp_path / "ck"
    argv = TINY_RUN + ["--checkpoint-dir", str(ck), "--metrics", str(tmp_path / "m.jsonl"),
                       "--epochs", "1"]
    if flag == "llm_model":
        _quiet(entry.main, argv + ["--llm-model", "LLAMA"])
        assert isinstance(seen["state"].model.llm_model, LlamaEncoder)
    else:
        want = _tiny_bert_checkpoint(tmp_path / "bert")
        _, log = _quiet(entry.main, argv + ["--llm-weights", str(tmp_path / "bert")])
        assert "loaded pretrained BERT backbone from" in log
        for k, v in seen["state"].model.llm_model.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_every_unported_flag_is_a_flag_of_hop_tpu():
    """The parallel flags, once the port's unported ones, are hop_tpu's, with
    its defaults and the same parsed values."""
    argv = ["--data-parallel", "4", "--model-parallel", "2", "--dcn-slices", "2",
            "--no-zero2"]
    for args in ([], argv):
        port = vars(C.base_parser("port").parse_args(args))
        ref = vars(JC.base_parser("jax").parse_args(args))
        for dest in ("data_parallel", "model_parallel", "dcn_slices", "no_zero2"):
            assert port[dest] == ref[dest], dest


def test_resume_refuses_another_seed(monkeypatch, tmp_path):
    """A checkpoint whose metadata records seed 2021 (and the tiny
    backbone) is refused by a resume with seed 7, before any step."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    llm = tcfg.tiny_test_config("TED").llm
    ckpt.metadata = {"seed": 2021, "llm_layers": llm.n_layers, "llm_dim": llm.dim}
    ckpt.save(0, {}, {"epoch": 0})
    argv = TINY_RUN + ["--checkpoint-dir", str(tmp_path / "ck"),
                       "--metrics", str(tmp_path / "m.jsonl"), "--epochs", "2", "--resume"]
    steps = []
    monkeypatch.setattr(train_main, "run_training", lambda *a, **k: steps.append(1))
    with pytest.raises(SystemExit, match="seed=2021.*this run has seed=7"):
        _quiet(run_ted.main, argv + ["--seed", "7"])
    assert not steps


def test_test_checkpoint_without_a_checkpoint_says_random_init(tmp_path):
    argv = ["--device", "cpu", "--tiny", "--clip-seconds", "2"]
    out, log = _quiet(test_checkpoint.main, argv + ["--checkpoint-dir", str(tmp_path)])
    assert "no checkpoint found — using random init (seed 2021)" in log
    ref, log = _quiet(test_checkpoint.main, argv)
    assert "no --checkpoint-dir — using random init (seed 2021)" in log
    assert out.shape == ref.shape == (34, 27)
    assert (out == ref).all()
