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

Tensor parallelism over a model group (`shard_`, the counterpart of
hop_tpu's `_col` / `_row` partitioning, bert.py:41-48, 94-98, 139, 161-168,
187-190): query, key, value and the intermediate dense are column-parallel,
each rank keeping its rows of their weights and biases, split by whole
heads; the attention output and the output dense are row-parallel, each
rank keeping its columns, the products summed over the group
(`reduce_from_group`) and the bias added once, after the sum. The input of
the column-parallel products goes through `copy_to_group`, so the gradient
that reaches the backbone's input (what trains the reprogramming layer) is
the sum over the group. The residual dropouts draw the same masks on every
rank of the group (one generator, the same draws); the plain route draws
the probabilities' mask for every head and keeps the rank's, so its masks
are the unsharded layer's; the kernel routes fold `attn_seed` with the
rank. The bf16 cast of `_linear` casts the rank's slice only.
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
from hop_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group

ATTENTION_ROUTES = ("plain", "fused", "block")


def _compute_dtype(cfg: LLMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_bf16 else torch.float32


def _linear(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """Dense in the compute dtype: operands and result in `dt`."""
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _row_linear(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype, group) -> torch.Tensor:
    """A row-parallel dense in the compute dtype: this rank's columns of the
    weight, the products summed over `group` in f32, the bias added once."""
    y = reduce_from_group(F.linear(x.to(dt), layer.weight.to(dt)).float(), group)
    if layer.bias is not None:
        y = y + layer.bias.to(dt).float()
    return y.to(dt)


def shard_linear_(layer: nn.Linear, rank: int, size: int, rows: bool) -> None:
    """Keep this rank's share of a frozen dense: its block of output rows
    (column-parallel: weight and bias) or of input columns (row-parallel:
    the weight; the bias stays whole)."""
    def cut(t, dim):
        k = t.shape[dim] // size
        return nn.Parameter(t.narrow(dim, rank * k, k).clone(), requires_grad=False)
    layer.weight = cut(layer.weight.data, 0 if rows else 1)
    if rows and layer.bias is not None:
        layer.bias = cut(layer.bias.data, 0)


def refuse_degree(size: int, **widths) -> None:
    """A tensor-parallel degree that does not divide every width is refused
    by name."""
    bad = [f"{name} {w}" for name, w in widths.items() if w % size]
    if bad:
        raise SystemExit(f"--model-parallel {size} does not divide the backbone's "
                         + ", ".join(bad))


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
        self.tp = None                 # (group, rank, size) once sharded
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
        group, rank, size = self.tp or (None, 0, 1)
        H = cfg.n_heads // size
        D = cfg.dim // cfg.n_heads
        sa = self.attention.self
        xp = copy_to_group(x, group)
        q, k, v = (_linear(xp, lin, dt).reshape(B, T, H, D)
                   for lin in (sa.query, sa.key, sa.value))
        if self.route == "plain":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            scores = (q @ k.transpose(-1, -2)) / (D ** 0.5)      # (B, H, T, T)
            probs = torch.softmax(scores, dim=-1)
            if rate > 0.0 and size > 1:     # every head's mask, this rank's heads
                keep = torch.rand((B, cfg.n_heads, T, T), generator=generator,
                                  device=x.device)[:, rank * H:(rank + 1) * H] >= rate
                probs = probs * keep / (1.0 - rate)
            else:
                probs = dropout(probs, rate, generator)
            ctx = (probs.to(dt) @ v).transpose(1, 2)
        else:
            kernel = fused_attention if self.route == "fused" else block_attention
            seed = fold_seed(attn_seed, rank) if size > 1 else attn_seed
            ctx = kernel(q, k, v, 1.0 / D ** 0.5, rate, seed)
        ctx = ctx.reshape(B, T, H * D)
        out = self.attention.output.dense
        attn = (_linear(ctx, out, dt) if group is None else _row_linear(ctx, out, dt, group))
        x = self.attention.output.LayerNorm(x + dropout(attn.float(), rate, generator))
        h = F.gelu(_linear(copy_to_group(x, group), self.intermediate.dense, dt),
                   approximate="none")
        out = self.output.dense
        h = (_linear(h, out, dt) if group is None else _row_linear(h, out, dt, group))
        return self.output.LayerNorm(x + dropout(h.float(), rate, generator))

    def shard_(self, group, rank: int, size: int) -> None:
        """Keep this rank's share of the layer's denses for tensor
        parallelism over `group` (`size` ranks)."""
        sa = self.attention.self
        for lin in (sa.query, sa.key, sa.value, self.intermediate.dense):
            shard_linear_(lin, rank, size, rows=True)
        for lin in (self.attention.output.dense, self.output.dense):
            shard_linear_(lin, rank, size, rows=False)
        self.tp = (group, rank, size)


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

    def shard_(self, group, rank: int, size: int) -> None:
        """Tensor parallelism over `group`: every layer keeps rank `rank`'s
        share of its denses (`BertLayer.shard_`). A degree that does not
        divide the heads and the FFN width is refused."""
        cfg = self.encoder.layer[0].cfg
        refuse_degree(size, n_heads=cfg.n_heads, intermediate_dim=cfg.intermediate_dim)
        for layer in self.encoder.layer:
            layer.shard_(group, rank, size)

    def tp_slice(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """This rank's share of the state_dict entry `key` of the unsharded
        backbone (what `shard_` keeps of it); the tensor itself where the
        backbone is not sharded."""
        tp = self.encoder.layer[0].tp
        if tp is None:
            return value
        _, rank, size = tp
        if key.endswith(("attention.self.query.weight", "attention.self.key.weight",
                         "attention.self.value.weight", "intermediate.dense.weight",
                         "attention.self.query.bias", "attention.self.key.bias",
                         "attention.self.value.bias", "intermediate.dense.bias")):
            dim = 0
        elif key.endswith(("attention.output.dense.weight", "output.dense.weight")) \
                and ".layer." in key:
            dim = 1
        else:
            return value
        k = value.shape[dim] // size
        return value.narrow(dim, rank * k, k)

    def set_attention(self, route: str) -> None:
        """Switch every layer's self-attention route (same weights)."""
        if route not in ATTENTION_ROUTES:
            raise ValueError(f"attention route must be one of {ATTENTION_ROUTES}, "
                             f"got {route!r}")
        for layer in self.encoder.layer:
            layer.route = route

