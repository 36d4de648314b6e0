"""Parameter surgery (port of hop_tpu/utils/params.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def set_pretrained_embeddings(module: nn.Module, weights: np.ndarray) -> int:
    """Copy pretrained word vectors into every embedding table of `module`
    shaped like them, (n_words, wordembed_dim): the reference's
    `nn.Embedding.from_pretrained(word_embedding_weights)`
    (multimodal_context_net.py:38-44, seq2seq_net.py:27-31). Other tables
    (the speaker embedding) differ in shape and are left alone. Returns the
    number of tables replaced."""
    w = torch.as_tensor(np.asarray(weights))
    n = 0
    for m in module.modules():
        if isinstance(m, nn.Embedding) and tuple(m.weight.shape) == tuple(w.shape):
            m.weight.copy_(w)
            n += 1
    return n
