"""BERT-style encoder, the frozen LLM backbone (port of hop_tpu/models/bert.py).

Semantics of HF BertModel(inputs_embeds=...): position and token-type
embeddings are added, then LayerNorm, then post-LN blocks with an
exact-GELU FFN; no attention mask. Module names are HF's, so
`state_dict()` keys are those `hop_tpu.models.bert.convert_hf_bert_params`
reads (`embeddings.*`, `encoder.layer.{i}.*`).

Under `LLMConfig.compute_bf16` every matmul runs with bf16 operands and a
bf16 result, as the JAX Dense(dtype=bfloat16) layers do; LayerNorm and the
residual sums stay f32.

Self-attention has three routes, chosen by `LLMConfig.attention` (the JAX
module's branch at hop_tpu/models/bert.py:104-138, which it takes by the
environment variables HOP_TPU_PALLAS_ATTN / HOP_TPU_PALLAS_BLOCK_ATTN):
"plain", the default as in the JAX package, is a matmul + softmax outside
any kernel; "fused" is kernel K4 (ops/attention.py), one (sample, head) a
block; "block" is kernel K5 (ops/block_attention.py), samples stacked under
a block-diagonal mask. On the kernel routes q, k, v stay (B, T, H, D) as the
projections emit them, and the softmax is f32 whatever the compute dtype.

Dropout at `dropout_rate` (0.1, as HF's and the JAX module's) sits where
the JAX module has it (hop_tpu/models/bert.py:136,166,183,193,218-233):
after the embeddings' LayerNorm, on the attention probabilities, on the
attention output and on the FFN output. It is on only when the caller
passes `deterministic=False`, with the masks drawn from `generator`; the
HOP model gates that by `llm_train`, apart from its own train mode. On the
kernel routes the probabilities' mask is drawn inside the kernel instead,
from `attn_seed` folded with the layer's index, and `generator` serves the
other three sites.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.config import LLMConfig
from hop_tpu_torch.ops.attention import fused_attention
from hop_tpu_torch.ops.block_attention import block_attention
from hop_tpu_torch.ops.dropout import dropout, fold_seed

ATTENTION_ROUTES = ("plain", "fused", "block")


def _compute_dtype(cfg: LLMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_bf16 else torch.float32


def _linear(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """Dense in the compute dtype: operands and result in `dt`."""
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.dim)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.dim)
        self.LayerNorm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        T = inputs_embeds.shape[1]
        pos = self.position_embeddings.weight[:T]
        typ = self.token_type_embeddings.weight[0]
        return self.LayerNorm(inputs_embeds + pos[None] + typ)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.query = nn.Linear(cfg.dim, cfg.dim)
        self.key = nn.Linear(cfg.dim, cfg.dim)
        self.value = nn.Linear(cfg.dim, cfg.dim)


class BertOutput(nn.Module):
    """dense + LayerNorm(x + dense(h)); HF's BertSelfOutput / BertOutput."""

    def __init__(self, in_dim: int, cfg: LLMConfig):
        super().__init__()
        self.dense = nn.Linear(in_dim, cfg.dim)
        self.LayerNorm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertOutput(cfg.dim, cfg)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.dim, cfg.intermediate_dim)


class BertLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        if cfg.attention not in ATTENTION_ROUTES:
            raise ValueError(f"LLMConfig.attention must be one of "
                             f"{ATTENTION_ROUTES}, got {cfg.attention!r}")
        self.cfg = cfg
        self.route = cfg.attention     # a plain attribute: a caller may switch it
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg.intermediate_dim, cfg)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                attn_seed: int = 0) -> torch.Tensor:
        """`attn_seed` seeds the probabilities' dropout on the kernel routes."""
        cfg = self.cfg
        dt = _compute_dtype(cfg)
        B, T, _ = x.shape
        H = cfg.n_heads
        D = cfg.dim // H
        sa = self.attention.self
        q, k, v = (_linear(x, lin, dt).reshape(B, T, H, D)
                   for lin in (sa.query, sa.key, sa.value))
        if self.route == "plain":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            scores = (q @ k.transpose(-1, -2)) / (D ** 0.5)      # (B, H, T, T)
            probs = dropout(torch.softmax(scores, dim=-1), rate, generator).to(dt)
            ctx = (probs @ v).transpose(1, 2)
        else:
            kernel = fused_attention if self.route == "fused" else block_attention
            ctx = kernel(q, k, v, 1.0 / D ** 0.5, rate, attn_seed)
        ctx = ctx.reshape(B, T, cfg.dim)
        attn = _linear(ctx, self.attention.output.dense, dt).float()
        x = self.attention.output.LayerNorm(x + dropout(attn, rate, generator))
        h = F.gelu(_linear(x, self.intermediate.dense, dt), approximate="none")
        h = _linear(h, self.output.dense, dt).float()
        return self.output.LayerNorm(x + dropout(h, rate, generator))


class BertEncoderStack(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.n_layers))


class BertEncoder(nn.Module):
    """Embeddings + encoder stack; accepts token ids or raw embeddings."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.dropout_rate = 0.1
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoderStack(cfg)

    @property
    def word_embeddings(self) -> torch.Tensor:
        return self.embeddings.word_embeddings.weight

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """get_input_embeddings()(ids): the word table only (HOP.py:198)."""
        return self.embeddings.word_embeddings(token_ids)

    def forward(self, inputs_embeds: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                attn_seed: int = 0) -> torch.Tensor:
        """`attn_seed`: the kernel routes' dropout seed; each layer gets it
        folded with its index, so the layers draw different masks."""
        rate = 0.0 if deterministic else self.dropout_rate
        x = dropout(self.embeddings(inputs_embeds), rate, generator)
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, rate, generator, fold_seed(attn_seed, i))
        return x

    def set_attention(self, route: str) -> None:
        """Switch every layer's self-attention route (same weights)."""
        if route not in ATTENTION_ROUTES:
            raise ValueError(f"attention route must be one of {ATTENTION_ROUTES}, "
                             f"got {route!r}")
        for layer in self.encoder.layer:
            layer.route = route

