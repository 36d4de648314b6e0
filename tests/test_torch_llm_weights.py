"""--llm-weights in the port (hop_tpu_torch.models.llm_weights) against
hop_tpu's loader and HF's `from_pretrained`, on HF-format checkpoints
fabricated on disk here (`save_pretrained` of seeded random models, or the
port's own safetensors writer; nothing is downloaded).

Every case of tests/test_llm_weights.py has its mirror: the disk round trip
(safetensors and .bin) against `from_pretrained` and against hop_tpu's
`load_llm_params` forward, a deeper checkpoint truncated, a bare state-dict
file with a task prefix, the geometry and `--hf-vocab` checks (the same
messages, word for word), a LLaMA checkpoint, `run_ted --llm-weights` and
the restore, and the install keeping the model's parameters. Beyond
hop_tpu: bf16 checkpoints, sharded ones (`*.index.json`, only the shards a
depth needs opened), missing and misshapen arrays, and the unused ones
printed. Forwards are f32 (compute_bf16=False): 1e-5 absolute against
hop_tpu's and HF's on O(1) outputs; weights are held bitwise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu import config as jcfg
from hop_tpu.models.bert import BertEncoder as JaxBert
from hop_tpu.models.llama import LlamaEncoder as JaxLlama
from hop_tpu.models import llm_weights as jweights

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.models import llm_weights as W
from hop_tpu_torch.models.bert import BertEncoder
from hop_tpu_torch.models.llama import LlamaEncoder
from hop_tpu_torch.utils import safetensors_io

transformers = pytest.importorskip("transformers")

TOL = 1e-5
SMALL = tcfg.LLMConfig(dim=64, n_layers=2, n_heads=4, intermediate_dim=128,
                       vocab_size=100, max_position=64, compute_bf16=False)
SMALL_LLAMA = dataclasses.replace(SMALL, model="LLAMA", n_kv_heads=2)


def _jax_cfg(cfg):
    fields = {f.name for f in dataclasses.fields(jcfg.LLMConfig)}
    return jcfg.LLMConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                             if k in fields})


class _Holder(torch.nn.Module):
    """What install_llm_weights reads of a HOPModel: `llm_model`."""

    def __init__(self, cfg):
        super().__init__()
        self.llm_model = (LlamaEncoder if cfg.model == "LLAMA" else BertEncoder)(cfg)
        self.llm_model.requires_grad_(False)


def _hf_bert(cfg=SMALL, n_layers=None, seed=0):
    hf_cfg = transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        num_hidden_layers=n_layers or cfg.n_layers, num_attention_heads=cfg.n_heads,
        intermediate_size=cfg.intermediate_dim, max_position_embeddings=cfg.max_position,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    return transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()


def _hf_llama(cfg=SMALL_LLAMA, n_layers=None, seed=0, causal_lm=False):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.intermediate_dim,
        num_hidden_layers=n_layers or cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads or cfg.n_heads,
        max_position_embeddings=cfg.max_position, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, attn_implementation="eager")
    torch.manual_seed(seed)
    cls = transformers.LlamaForCausalLM if causal_lm else transformers.LlamaModel
    return cls(hf_cfg).eval()


def _save(hf, d, fmt="safetensors", **kw):
    hf.save_pretrained(str(d), safe_serialization=(fmt == "safetensors"), **kw)
    return str(d)


def _embeds(cfg, seed=1):
    return np.random.default_rng(seed).normal(size=(2, 34, cfg.dim)).astype(np.float32)


def _port_forward(holder, x):
    with torch.inference_mode():
        return holder.llm_model(torch.from_numpy(x)).numpy()


def _hf_forward(hf, x):
    with torch.inference_mode():
        return hf(inputs_embeds=torch.from_numpy(x)).last_hidden_state.float().numpy()


def _jax_forward(cfg, params, x):
    enc = (JaxLlama if cfg.model == "LLAMA" else JaxBert)(_jax_cfg(cfg))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(enc.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("cfg", [SMALL, SMALL_LLAMA], ids=["bert", "llama"])
def test_disk_roundtrip_matches_from_pretrained_and_hop_tpu(tmp_path, fmt, cfg):
    """install_llm_weights(dir) forward == from_pretrained(dir) forward ==
    hop_tpu's load_llm_params(dir) forward."""
    hf = _hf_bert() if cfg.model == "BERT" else _hf_llama()
    d = _save(hf, tmp_path / "ckpt", fmt)
    assert os.path.exists(os.path.join(d, W._WEIGHT_FILES[fmt == "bin"]))
    holder = _Holder(cfg)
    info = W.install_llm_weights(holder, d, cfg)
    assert info["bytes"] == sum(v.numel() * 4 for v in holder.llm_model.state_dict().values())
    x = _embeds(cfg)
    got = _port_forward(holder, x)
    live = type(hf).from_pretrained(d).eval()
    np.testing.assert_allclose(got, _hf_forward(live, x), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _jax_forward(cfg, jweights.load_llm_params(
        d, _jax_cfg(cfg)), x), rtol=0, atol=TOL)


def test_deeper_checkpoint_truncates_like_from_pretrained(tmp_path):
    """A 4-layer checkpoint serves a 2-layer config: the first two layers."""
    hf = _hf_bert(n_layers=4)
    d = _save(hf, tmp_path / "ckpt")
    sd = W.load_llm_state_dict(d, SMALL)
    assert not any(k.startswith(("encoder.layer.2.", "encoder.layer.3.")) for k in sd)
    assert torch.equal(sd["encoder.layer.1.attention.self.query.weight"],
                       hf.state_dict()["encoder.layer.1.attention.self.query.weight"])
    assert set(sd) == set(BertEncoder(SMALL).state_dict())


def test_bare_state_dict_file_and_task_prefix(tmp_path, capsys):
    """A bare .bin state dict whose keys carry the bert. task prefix; the
    task head is dropped with the prefix, nothing reported unused."""
    hf = _hf_bert()
    sd = {"bert." + k: v for k, v in hf.state_dict().items()}
    sd["cls.predictions.bias"] = torch.zeros(SMALL.vocab_size)
    p = str(tmp_path / "wrapped.bin")
    torch.save(sd, p)
    got = W.load_llm_state_dict(p, SMALL)
    assert torch.equal(got["embeddings.word_embeddings.weight"],
                       hf.state_dict()["embeddings.word_embeddings.weight"])
    assert "unused" not in capsys.readouterr().out


@pytest.mark.parametrize("change,match", [
    ({"vocab_size": 101}, "vocab size"), ({"dim": 128}, "hidden size"),
    ({"n_layers": 3}, "layers"), ({"model": "LLAMA"}, "BERT")])
def test_geometry_mismatches_fail_fast_with_hop_tpus_messages(tmp_path, change, match):
    d = _save(_hf_bert(), tmp_path / "ckpt")
    cfg = dataclasses.replace(SMALL, **change)
    with pytest.raises(ValueError, match=match) as got:
        W.load_llm_state_dict(d, cfg)
    with pytest.raises(ValueError) as want:
        jweights.load_llm_params(d, _jax_cfg(cfg))
    assert str(got.value) == str(want.value)


def test_layer_probe_and_family_messages_equal_hop_tpus(tmp_path):
    """Without config.json the layer probe speaks; an unknown family too."""
    hf = _hf_llama()
    p = str(tmp_path / "bare.safetensors")
    safetensors_io.write(hf.state_dict(), p)
    cfg = dataclasses.replace(SMALL_LLAMA, n_layers=3)
    with pytest.raises(ValueError, match="lacks encoder layer 2") as got:
        W.load_llm_state_dict(p, cfg)
    with pytest.raises(ValueError) as want:
        jweights.load_llm_params(p, _jax_cfg(cfg))
    assert str(got.value) == str(want.value)
    odd = str(tmp_path / "odd.safetensors")
    safetensors_io.write({"foo.weight": torch.zeros(2), "bar": torch.zeros(1)}, odd)
    with pytest.raises(ValueError) as got:
        W.load_llm_state_dict(odd, SMALL)
    with pytest.raises(ValueError) as want:
        jweights.load_llm_params(odd, _jax_cfg(SMALL))
    assert str(got.value) == str(want.value)


def test_hf_vocab_consistency(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(f"tok{i}" for i in range(SMALL.vocab_size)) + "\n")
    W.check_vocab_consistency("x", SMALL, str(vocab))
    vocab.write_text("\n".join(f"tok{i}" for i in range(7)) + "\n")
    with pytest.raises(ValueError, match="--hf-vocab") as got:
        W.check_vocab_consistency("x", SMALL, str(vocab))
    with pytest.raises(ValueError) as want:
        jweights.check_vocab_consistency("x", _jax_cfg(SMALL), str(vocab))
    assert str(got.value) == str(want.value)


def test_llama_checkpoint_from_disk_with_model_prefix(tmp_path):
    """A LlamaForCausalLM checkpoint (model. prefix, lm_head) loads into the
    LLaMA backbone: equal to hop_tpu's conversion, lm_head dropped."""
    hf = _hf_llama(causal_lm=True)
    d = _save(hf, tmp_path / "ckpt")
    sd = W.load_llm_state_dict(d, SMALL_LLAMA)
    params = jweights.load_llm_params(d, _jax_cfg(SMALL_LLAMA))
    np.testing.assert_array_equal(sd["layers.0.self_attn.q_proj.weight"].numpy(),
                                  params["layer_0"]["self_attn"]["q_proj"]["kernel"].T)
    assert set(sd) == set(LlamaEncoder(SMALL_LLAMA).state_dict())


@pytest.mark.parametrize("cfg", [SMALL, SMALL_LLAMA], ids=["bert", "llama"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_bf16_sharded_checkpoint_matches_from_pretrained(tmp_path, cfg, fmt):
    """A bf16 checkpoint in shards (`*.index.json`), as HF publishes
    LLaMA-7B: hop_tpu cannot read it (numpy has no bfloat16; one file only);
    the port's weights are the checkpoint's, cast to f32 bitwise, and its
    forward is `from_pretrained`'s (which upcasts to f32 too)."""
    hf = (_hf_bert() if cfg.model == "BERT" else _hf_llama()).to(torch.bfloat16)
    d = _save(hf, tmp_path / "ckpt", fmt, max_shard_size="40KB")
    index = W._INDEX_FILES[fmt == "bin"]
    with open(os.path.join(d, index)) as f:
        assert len(set(json.load(f)["weight_map"].values())) > 2
    holder = _Holder(cfg)
    W.install_llm_weights(holder, d, cfg)
    hf_sd = hf.state_dict()
    for k, v in holder.llm_model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, hf_sd[k].float()), k
    live = type(hf).from_pretrained(d, torch_dtype=torch.float32).eval()
    x = _embeds(cfg)
    np.testing.assert_allclose(_port_forward(holder, x), _hf_forward(live, x),
                               rtol=0, atol=TOL)


def test_only_the_shards_a_depth_needs_are_opened(tmp_path, monkeypatch):
    """A 4-layer sharded checkpoint at depth 2: the shard of layers 2-3 is
    never read."""
    hf = _hf_llama(n_layers=4)
    sd = hf.state_dict()
    deep = [k for k in sd if k.startswith(("layers.2.", "layers.3."))]
    shards = {"model-1.safetensors": {k: v for k, v in sd.items() if k not in deep},
              "model-2.safetensors": {k: sd[k] for k in deep}}
    d = tmp_path / "ckpt"
    d.mkdir()
    for name, part in shards.items():
        safetensors_io.write(part, str(d / name))
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: n for n, p in shards.items() for k in p}}))
    (d / "config.json").write_text(json.dumps({"num_hidden_layers": 4}))
    opened = []
    read = safetensors_io.read
    monkeypatch.setattr(safetensors_io, "read",
                        lambda path, names=None: opened.append(path) or read(path, names))
    holder = _Holder(SMALL_LLAMA)
    W.install_llm_weights(holder, str(d), SMALL_LLAMA)
    assert [os.path.basename(p) for p in opened] == ["model-1.safetensors"]
    assert torch.equal(holder.llm_model.layers[1].mlp.up_proj.weight,
                       sd["layers.1.mlp.up_proj.weight"])


def test_missing_misshapen_and_unused_arrays(tmp_path, capsys):
    sd = _hf_llama().state_dict()
    p = str(tmp_path / "x.safetensors")
    safetensors_io.write({k: v for k, v in sd.items()
                          if k != "layers.1.mlp.up_proj.weight"}, p)
    with pytest.raises(ValueError, match="checkpoint missing backbone array "
                                         "layers.1.mlp.up_proj.weight"):
        W.load_llm_state_dict(p, SMALL_LLAMA)
    safetensors_io.write({**sd, "layers.1.mlp.up_proj.weight": torch.zeros(3, 64)}, p)
    with pytest.raises(ValueError, match=r"backbone array layers.1.mlp.up_proj.weight: "
                                         r"checkpoint shape \(3, 64\) != model \(128, 64\)"):
        W.load_llm_state_dict(p, SMALL_LLAMA)
    safetensors_io.write({**sd, "extra.weight": torch.zeros(2),
                          "rotary_emb.inv_freq": torch.zeros(8)}, p)
    W.load_llm_state_dict(p, SMALL_LLAMA)
    out = capsys.readouterr().out
    assert "unused by this model instantiation: extra.weight" in out
    assert "inv_freq" not in out


def test_install_keeps_the_models_parameters(tmp_path):
    """The install writes into the model's own frozen parameters (same
    objects, dtype and requires_grad); hop_tpu's keeps its flax boxes."""
    d = _save(_hf_bert(), tmp_path / "ckpt")
    holder = _Holder(SMALL)
    params = dict(holder.llm_model.named_parameters())
    W.install_llm_weights(holder, d, SMALL)
    after = dict(holder.llm_model.named_parameters())
    assert all(after[k] is p and p.dtype == torch.float32 and not p.requires_grad
               for k, p in params.items())


def test_cli_trains_with_pretrained_backbone(tmp_path, monkeypatch):
    """run_ted --llm-weights: one epoch through the CLI; the trained
    state's frozen backbone equals the checkpoint's arrays, the metadata
    records the path, and restore_hop_model reloads the backbone from it."""
    import tempfile
    from hop_tpu_torch.cli import common as C
    from hop_tpu_torch.cli import run_ted
    from hop_tpu_torch.utils.checkpoint import CheckpointManager
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tiny = tcfg.tiny_test_config("TED").llm
    hf = _hf_bert(dataclasses.replace(SMALL, vocab_size=tiny.vocab_size))
    d = _save(hf, tmp_path / "bert")
    ck = str(tmp_path / "ck")
    state, _ = run_ted.main(["--device", "cpu", "--tiny", "--synthetic-videos", "1",
                             "--batch-size", "13", "--epochs", "1", "--warmup-epochs", "0",
                             "--llm-weights", d, "--checkpoint-dir", ck,
                             "--metrics", str(tmp_path / "m.jsonl")])
    want = hf.state_dict()
    for k, v in state.model.llm_model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert CheckpointManager(ck).run_metadata()["llm_weights"] == os.path.abspath(d)
    _, model, _ = C.restore_hop_model(tcfg.tiny_test_config("TED"), ck, device="cpu")
    for k, v in model.llm_model.state_dict().items():
        assert torch.equal(v, want[k]), k
