"""Reprogramming cross-attention: mel frames attend over text prototypes
(port of hop_tpu/models/reprogramming.py; reference model/HOP.py:255-299).

Queries are the (B, 34, d_model=128) log-mel frames; keys and values are
S=1500 prototype embeddings mixed from the frozen LLM's vocabulary table by
`PrototypeMapper`. The attention itself is kernel K1
(ops/reprogramming_attention.py) on CUDA. In training mode it drops
attention probabilities at `attention_dropout` = 0.1 (JAX
reprogramming.py:51-58), the mask drawn inside the kernel from the `seed`
the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.ops.reprogramming_attention import reprogramming_attention


class ReprogrammingLayer(nn.Module):
    """(B, L, d_model), (S, d_llm), (S, d_llm) -> (B, L, d_llm)."""

    def __init__(self, d_model: int, n_heads: int, d_keys: int, d_llm: int):
        super().__init__()
        self.n_heads, self.d_keys = n_heads, d_keys
        self.attention_dropout = 0.1
        self.query_projection = nn.Linear(d_model, n_heads * d_keys)
        self.key_projection = nn.Linear(d_llm, n_heads * d_keys)
        self.value_projection = nn.Linear(d_llm, n_heads * d_keys)
        self.out_projection = nn.Linear(n_heads * d_keys, d_llm)

    def forward(self, target_embedding: torch.Tensor,
                source_embedding: torch.Tensor,
                value_embedding: torch.Tensor, seed: int = 0) -> torch.Tensor:
        H, E = self.n_heads, self.d_keys
        B, L, _ = target_embedding.shape
        S = source_embedding.shape[0]
        q = self.query_projection(target_embedding).reshape(B, L, H, E)
        k = self.key_projection(source_embedding).reshape(S, H, E)
        v = self.value_projection(value_embedding).reshape(S, H, E)
        rate = self.attention_dropout if self.training else 0.0
        out = reprogramming_attention(q, k.transpose(0, 1), v.transpose(0, 1),
                                      1.0 / math.sqrt(E), rate, seed)
        return self.out_projection(F.relu(out.reshape(B, L, H * E)))


class PrototypeMapper(nn.Module):
    """mapping_layer: S prototypes, each a learned mixture over the vocabulary.

    Keeps the reference's nn.Linear(vocab, S) layout: weight (S, vocab),
    source = weight @ W_emb + bias[:, None] (HOP.py:115-116, 200)."""

    def __init__(self, vocab_size: int, num_tokens: int):
        super().__init__()
        bound = 1.0 / math.sqrt(vocab_size)
        self.weight = nn.Parameter(
            torch.empty(num_tokens, vocab_size).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(num_tokens).uniform_(-bound, bound))

    def forward(self, word_embeddings: torch.Tensor) -> torch.Tensor:
        """(vocab, d_llm) -> (num_tokens, d_llm)."""
        return self.weight @ word_embeddings + self.bias[:, None]
