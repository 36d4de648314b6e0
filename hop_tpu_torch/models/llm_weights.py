"""Pretrained frozen-backbone weights from an HF checkpoint on disk (port of
hop_tpu/models/llm_weights.py; `--llm-weights`).

The reference's live path loads a pretrained frozen backbone: BERT through
`BertModel.from_pretrained('bert-base-uncased', num_hidden_layers=6)`
(run_ted.py:176-212) or LLaMA-7B (run_ted.py:133-175). This module reads an
HF-format checkpoint from disk, checks it against the configured backbone's
geometry and the `--hf-vocab` tokenizer, and loads it into the model's
`llm_model`. HF's names are the port's own for both families
(`models/bert.py`, `models/llama.py`), so nothing is renamed.

What it reads: a directory with `config.json` and `model.safetensors`,
`pytorch_model.bin`, or a sharded checkpoint (`model.safetensors.index.json`
or `pytorch_model.bin.index.json` and the shards their `weight_map` names),
or a bare state-dict file. safetensors files are read by the port's own
reader (`utils.safetensors_io`: the machine with the card has neither the
`safetensors` nor the `transformers` package); a `.bin` through
`torch.load(weights_only=True, mmap=True)`. Either way the tensors are views
of a map of the file until they are copied into the parameters, each cast
to the parameter's dtype.

As `from_pretrained` does: a checkpoint with more layers than
`cfg.n_layers` is valid (the first `n_layers` are taken, and of a sharded
checkpoint only the shards that hold what those need are opened); a
`bert.` / `model.` key prefix (a task wrapper's) is stripped; task heads
and HF's extras (`pooler.*`, `embeddings.position_ids`,
`rotary_emb.inv_freq`) are ignored. `_strip_prefix`, `_detect_family`,
`_check_geometry` and `check_vocab_consistency` are hop_tpu's, messages
word for word.

Where this differs from `hop_tpu` (its loader converts through numpy and
reads one file): bf16 tensors load (numpy has no bfloat16), and sharded
checkpoints load (the form HF publishes LLaMA-7B in).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional, Tuple

import torch
from torch import nn

from hop_tpu_torch.config import LLMConfig
from hop_tpu_torch.models.llama import make_llm_encoder
from hop_tpu_torch.utils import safetensors_io

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
_INDEX_FILES = ("model.safetensors.index.json", "pytorch_model.bin.index.json")
#: the layer index of a key (BERT's `encoder.layer.i.`, LLaMA's `layers.i.`)
_LAYER = re.compile(r"(?:^|\.)layers?\.(\d+)\.")
#: arrays of HF's models that the port's backbones have no use for
_EXTRAS = re.compile(r"(?:^|\.)(?:pooler\.|embeddings\.position_ids$|rotary_emb\.inv_freq$)")


def _layer_of(key: str) -> Optional[int]:
    m = _LAYER.search(key)
    return int(m.group(1)) if m else None


def _needed(key: str, n_layers: Optional[int]) -> bool:
    """Whether a backbone of `n_layers` layers may read `key`."""
    layer = _layer_of(key)
    return n_layers is None or layer is None or layer < n_layers


def _read_file(path: str, names=None) -> dict:
    if path.endswith(".safetensors"):
        return safetensors_io.read(path, names)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return sd if names is None else {k: sd[k] for k in names}


def _read_state_dict(path: str, n_layers: Optional[int] = None) -> Tuple[dict, Optional[dict]]:
    """(state_dict, config.json dict or None) from a file or an HF
    directory. Of a sharded checkpoint, only the arrays a backbone of
    `n_layers` layers may read are read, from the shards that hold them."""
    hf_config = None
    if not os.path.isdir(path):
        return _read_file(path), hf_config
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            hf_config = json.load(f)
    for name in _WEIGHT_FILES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            return _read_file(p), hf_config
    for name in _INDEX_FILES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            with open(p) as f:
                weight_map = json.load(f)["weight_map"]
            shards: dict = {}
            for key, shard in weight_map.items():
                if _needed(key, n_layers):
                    shards.setdefault(shard, []).append(key)
            sd = {}
            for shard, keys in shards.items():
                sd.update(_read_file(os.path.join(path, shard), keys))
            return sd, hf_config
    raise FileNotFoundError(f"no {' / '.join(_WEIGHT_FILES + _INDEX_FILES)} in {path}")


def _strip_prefix(sd: dict) -> dict:
    """Drop a uniform task-wrapper prefix (bert. / model.) if present."""
    for prefix in ("bert.", "model."):
        if any(k.startswith(prefix + "embeddings.") for k in sd) or \
           any(k.startswith(prefix + "embed_tokens.") for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
    return sd


def _detect_family(sd: dict) -> str:
    if any(k.startswith("embeddings.word_embeddings") for k in sd):
        return "BERT"
    if any(k.startswith("embed_tokens.") for k in sd):
        return "LLAMA"
    raise ValueError(
        "unrecognised checkpoint: neither BERT (embeddings.word_embeddings)"
        " nor LLaMA (embed_tokens) keys found; sample keys: "
        + ", ".join(sorted(sd)[:5]))


def _check_geometry(sd: dict, hf_config: Optional[dict], cfg: LLMConfig,
                    family: str) -> None:
    """Fail fast with a specific message instead of a shape error mid-tree."""
    if family != cfg.model:
        raise ValueError(f"--llm-weights checkpoint is {family} but the "
                         f"configured backbone is {cfg.model} "
                         "(--llm-model)")
    emb_key = ("embeddings.word_embeddings.weight" if family == "BERT"
               else "embed_tokens.weight")
    vocab, dim = sd[emb_key].shape
    if dim != cfg.dim:
        raise ValueError(f"checkpoint hidden size {dim} != configured "
                         f"llm dim {cfg.dim}")
    if vocab != cfg.vocab_size:
        raise ValueError(
            f"checkpoint vocab size {vocab} != configured {cfg.vocab_size}"
            " — the reprogramming mapping_layer (vocab -> 1500 prototypes,"
            " reference HOP.py:115-116) is sized from the embedding table;"
            " a mismatched table would silently scramble the prototypes")
    if hf_config is not None:
        n_avail = hf_config.get("num_hidden_layers")
        if n_avail is not None and n_avail < cfg.n_layers:
            raise ValueError(f"checkpoint has {n_avail} layers < configured "
                             f"--llm-layers {cfg.n_layers}")
    # layer presence check independent of config.json
    probe = (f"encoder.layer.{cfg.n_layers - 1}.attention.self.query.weight"
             if family == "BERT"
             else f"layers.{cfg.n_layers - 1}.self_attn.q_proj.weight")
    if probe not in sd:
        raise ValueError(f"checkpoint lacks encoder layer "
                         f"{cfg.n_layers - 1} ({probe})")


def check_vocab_consistency(path: str, cfg: LLMConfig,
                            hf_vocab: Optional[str]) -> None:
    """--hf-vocab tokenizer vs the checkpoint's embedding-table rows.

    The token-id stream produced from vocab.txt indexes straight into the
    loaded word-embedding table (and the 30522-row mapping_layer input,
    HOP.py:115-116), so the row counts must agree exactly."""
    if not hf_vocab:
        return
    with open(hf_vocab, encoding="utf-8") as f:
        n_tokens = sum(1 for _ in f)
    if n_tokens != cfg.vocab_size:
        raise ValueError(
            f"--hf-vocab {hf_vocab} has {n_tokens} tokens but the backbone "
            f"vocab (and --llm-weights embedding table) is {cfg.vocab_size}")


def load_llm_state_dict(path: str, cfg: LLMConfig,
                        hf_vocab: Optional[str] = None) -> dict:
    """HF checkpoint on disk -> the backbone's state_dict in the port's names
    (the checkpoint's tensors, in its dtype), every array the backbone has
    present and of its shape. Prints the checkpoint's arrays that the
    backbone does not read (but HF's extras and layers past `n_layers`)."""
    sd, hf_config = _read_state_dict(path, cfg.n_layers)
    sd = _strip_prefix(sd)
    family = _detect_family(sd)
    _check_geometry(sd, hf_config, cfg, family)
    check_vocab_consistency(path, cfg, hf_vocab)
    with torch.device("meta"):        # names and shapes, no memory
        want = make_llm_encoder(cfg).state_dict()
    out = {}
    for k, ref in want.items():
        if k not in sd:
            raise ValueError(f"checkpoint missing backbone array {k}")
        if tuple(sd[k].shape) != tuple(ref.shape):
            raise ValueError(f"backbone array {k}: checkpoint shape "
                             f"{tuple(sd[k].shape)} != model {tuple(ref.shape)}")
        out[k] = sd[k]
    unused = sorted(k for k in sd if k not in out and not _EXTRAS.search(k)
                    and _needed(k, cfg.n_layers))
    if unused:
        print("llm-weights: checkpoint arrays unused by this model "
              "instantiation: " + ", ".join(unused))
    return out


def install_llm_weights(model: nn.Module, path: str, cfg: LLMConfig,
                        hf_vocab: Optional[str] = None) -> dict:
    """Load the checkpoint at `path` into `model.llm_model` (a HOPModel's
    frozen backbone, on any device), each array cast to its parameter's
    dtype; of a backbone sharded for tensor parallelism, only this rank's
    share of each sharded array (`tp_slice`: a slice of the file's map, so
    only its pages are read). Returns {"bytes": bytes read, "seconds": the
    whole load}."""
    t0 = time.perf_counter()
    sd = load_llm_state_dict(path, cfg, hf_vocab)
    params = model.llm_model.state_dict()
    sd = {k: model.llm_model.tp_slice(k, v) for k, v in sd.items()}
    with torch.no_grad():
        for k, v in sd.items():
            params[k].copy_(v)
    return {"bytes": sum(v.numel() * v.element_size() for v in sd.values()),
            "seconds": time.perf_counter() - t0}
