"""LLaMA decoder, the reference's second frozen backbone (port of
hop_tpu/models/llama.py; reference run_ted.py:133-175, `--llm_model LLAMA`).

The reference truncates LLaMA-7B to `llm_layers` layers and calls
`LlamaModel(inputs_embeds=...)`: a causal decoder over the 34 aligned frame
slots with rotary position embeddings (rotate-half convention,
inv_freq = theta^(-2i/d)), RMSNorm pre-normalisation, a SwiGLU MLP,
grouped-query attention when `n_kv_heads < n_heads` and a final RMSNorm.
Children carry HF `LlamaModel`'s names (`embed_tokens`, `layers.{i}.
self_attn.{q,k,v,o}_proj`, `layers.{i}.mlp.{gate,up,down}_proj`,
`layers.{i}.{input,post_attention}_layernorm`, `norm`), so under
`llm_model.*` the state_dict is the reference's own and an HF checkpoint
loads by name (`models.llm_weights`).

Precision as the JAX module's: f32 parameters; under
`LLMConfig.compute_bf16` every product runs with bf16 operands and a bf16
result; RMSNorm, RoPE and the softmax in f32; each block's output back to
f32 before the residual sum (hop_tpu/models/llama.py:36-42, 83-97, 108-113).

Attention is plain products outside any kernel, as `hop_tpu` computes it
(`einsum`, llama.py:89-96): the backbone kernels K4 and K5 are BERT's
(T <= 64, D = 64, no causal mask), so `LLMConfig.attention` must be "plain".
LLaMA has no dropout: `forward` accepts BERT's `deterministic`,
`generator` and `attn_seed` and has no use for them.

Tensor parallelism over a model group (`LlamaEncoder.shard_`, hop_tpu's
llama.py:74-117): `q_proj`, `k_proj`, `v_proj`, `gate_proj` and `up_proj`
are column-parallel (each rank keeps its heads, its KV heads, its block of
the FFN width), `o_proj` and `down_proj` row-parallel (its columns, the
products summed over the group); the inputs of the column-parallel
products go through `copy_to_group`, as in `models/bert.py`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.config import LLMConfig
from hop_tpu_torch.models.bert import (BertEncoder, _compute_dtype, _linear, _row_linear,
                                       refuse_degree, shard_linear_)
from hop_tpu_torch.parallel.collectives import copy_to_group


class RMSNorm(nn.Module):
    """x / rms(x) * weight, in f32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        var = (x * x).mean(dim=-1, keepdim=True)
        return self.weight * x * torch.rsqrt(var + self.eps)


def rope_cos_sin(T: int, head_dim: int, theta: float,
                 device: torch.device | str | None = None):
    """HF-convention rotary tables: cos and sin of shape (T, head_dim), the
    head_dim / 2 frequencies duplicated [f, f] along the last axis."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    angles = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv_freq[None]
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); rotate_half: (x1, x2) -> (-x2, x1)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        head_dim = cfg.dim // cfg.n_heads
        n_kv = cfg.n_kv_heads or cfg.n_heads
        self.q_proj = nn.Linear(cfg.dim, cfg.dim, bias=False)
        self.k_proj = nn.Linear(cfg.dim, n_kv * head_dim, bias=False)
        self.v_proj = nn.Linear(cfg.dim, n_kv * head_dim, bias=False)
        self.o_proj = nn.Linear(cfg.dim, cfg.dim, bias=False)
        self.tp = None                 # (group, rank, size) once sharded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = _compute_dtype(cfg)
        B, T, _ = x.shape
        group, _, size = self.tp or (None, 0, 1)
        head_dim = cfg.dim // cfg.n_heads
        n_heads, n_kv = cfg.n_heads // size, (cfg.n_kv_heads or cfg.n_heads) // size
        x = copy_to_group(x, group)
        q = _linear(x, self.q_proj, dt).reshape(B, T, n_heads, head_dim)
        k = _linear(x, self.k_proj, dt).reshape(B, T, n_kv, head_dim)
        v = _linear(x, self.v_proj, dt).reshape(B, T, n_kv, head_dim)
        cos, sin = rope_cos_sin(T, head_dim, cfg.rope_theta, x.device)
        q = apply_rope(q.float(), cos, sin).to(dt)
        k = apply_rope(k.float(), cos, sin).to(dt)
        groups = n_heads // n_kv
        if groups > 1:      # grouped-query attention: repeat the kv heads
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, T, D)
        scores = (q @ k.transpose(-1, -2)) / (head_dim ** 0.5)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        scores = scores.float().masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx = (probs @ v).transpose(1, 2).reshape(B, T, n_heads * head_dim)
        if group is not None:
            return _row_linear(ctx, self.o_proj, dt, group).float()
        return _linear(ctx, self.o_proj, dt).float()


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = nn.Linear(cfg.dim, cfg.intermediate_dim, bias=False)
        self.up_proj = nn.Linear(cfg.dim, cfg.intermediate_dim, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_dim, cfg.dim, bias=False)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.cfg)
        group = self.tp[0] if self.tp else None
        x = copy_to_group(x, group)
        h = F.silu(_linear(x, self.gate_proj, dt)) * _linear(x, self.up_proj, dt)
        if group is not None:
            return _row_linear(h, self.down_proj, dt, group).float()
        return _linear(h, self.down_proj, dt).float()


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaEncoder(nn.Module):
    """The backbone interface `HOPModel.trunk` uses, as `BertEncoder`'s:
    token-table lookups (`embed_tokens`, `word_embeddings`) and the decoder
    over raw embeddings."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        if cfg.attention != "plain":
            raise ValueError(
                f"LLMConfig.attention={cfg.attention!r} with the LLaMA backbone: "
                "its attention is causal, with head_dim "
                f"{cfg.dim // cfg.n_heads}; the kernel routes (K4, K5) are BERT's "
                "(no mask, head_dim 64). LLaMA takes attention='plain' only")
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.layers = nn.ModuleList(LlamaLayer(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.rms_norm_eps)

    @property
    def word_embeddings(self) -> torch.Tensor:
        return self.embed_tokens.weight

    #: (column-parallel, row-parallel) projections of a layer
    COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    ROW = ("o_proj", "down_proj")

    def shard_(self, group, rank: int, size: int) -> None:
        """Tensor parallelism over `group`: every layer keeps rank `rank`'s
        share of its projections. A degree that does not divide the heads,
        the KV heads and the FFN width is refused."""
        cfg = self.layers[0].self_attn.cfg
        refuse_degree(size, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads or cfg.n_heads,
                      intermediate_dim=cfg.intermediate_dim)
        for layer in self.layers:
            for part in (layer.self_attn, layer.mlp):
                for name in self.COLUMN + self.ROW:
                    if hasattr(part, name):
                        shard_linear_(getattr(part, name), rank, size, name in self.COLUMN)
                part.tp = (group, rank, size)

    def tp_slice(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """This rank's share of the unsharded state_dict entry `key`."""
        tp = self.layers[0].self_attn.tp
        name = key.rsplit(".", 2)[-2] if key.count(".") >= 2 else ""
        if tp is None or name not in self.COLUMN + self.ROW:
            return value
        _, rank, size = tp
        dim = 0 if name in self.COLUMN else 1
        k = value.shape[dim] // size
        return value.narrow(dim, rank * k, k)

    def forward(self, inputs_embeds: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                attn_seed: int = 0) -> torch.Tensor:
        """The decoder over `inputs_embeds` (B, T, dim); the last three
        arguments are BERT's dropout controls, unused."""
        x = inputs_embeds
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


def make_llm_encoder(cfg: LLMConfig) -> nn.Module:
    """Backbone factory for HOPModel (hop_tpu/models/llama.py:197-207).
    Unknown values raise like the reference's 'LLM model is not defined'
    (run_ted.py:211)."""
    if cfg.model == "BERT":
        return BertEncoder(cfg)
    if cfg.model == "LLAMA":
        return LlamaEncoder(cfg)
    raise ValueError(f"LLM model is not defined: {cfg.model!r} "
                     "(supported: BERT, LLAMA)")
