"""Temporal convolutional network: causal dilated convolutions with weight
normalisation (port of hop_tpu/models/tcn.py; reference model/tcn.py:7-64).

A TemporalBlock is two weight-normed Conv1d with a causal left padding,
ReLU and dropout after each, and a residual 1x1 convolution where the
width changes. The weight norm keeps the reference's parameters
`weight_g` (out, 1, 1) and `weight_v` (out, in, k), which hop_tpu's
`convert_text_encoder_tcn` reads (not torch's newer
`parametrizations.weight.original0/1`): kernel = g * v / max(||v||, 1e-12),
the norm over (in, k) per output channel, as in hop_tpu. Layout (B, C, T)
inside; `TextEncoderTCN` takes token ids (its table a `common.WordEmbedding`, whose
gradient repeats bit for bit) and returns (B, T, 32). Dropout
runs in training mode, its masks drawn from the generator handed to
`forward`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.models import common
from hop_tpu_torch.ops.dropout import dropout as drop


class WeightNormConv1d(nn.Module):
    """Causal Conv1d (left padding (k - 1) * dilation) with weight norm."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pad = (kernel - 1) * dilation
        v = torch.randn(out_channels, in_channels, kernel) * 0.01
        self.weight_v = nn.Parameter(v)
        # g = ||v||: the initial kernel is v, as torch's weight_norm starts
        self.weight_g = nn.Parameter(v.flatten(1).norm(dim=1).reshape(-1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self.weight_v.flatten(1).norm(dim=1).clamp_min(1e-12)
        weight = self.weight_v * (self.weight_g.flatten() / norm)[:, None, None]
        return F.conv1d(F.pad(x, (self.pad, 0)), weight, self.bias,
                        dilation=self.dilation)


class TemporalBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dilation: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.conv1 = WeightNormConv1d(in_channels, out_channels, kernel, dilation)
        self.conv2 = WeightNormConv1d(out_channels, out_channels, kernel, dilation)
        self.downsample = None
        if in_channels != out_channels:
            self.downsample = nn.Conv1d(in_channels, out_channels, 1)
            nn.init.normal_(self.downsample.weight, std=0.01)
            nn.init.zeros_(self.downsample.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        y = drop(torch.relu(self.conv1(x)), rate, generator)
        y = drop(torch.relu(self.conv2(y)), rate, generator)
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class TemporalConvNet(nn.Module):
    """TemporalBlocks with dilation 2^i (reference tcn.py:49-64), under the
    reference's names `network.{i}`."""

    def __init__(self, in_channels: int, channels, kernel: int = 2,
                 dropout: float = 0.2):
        super().__init__()
        widths = [in_channels, *channels]
        self.network = nn.ModuleList(
            TemporalBlock(widths[i], widths[i + 1], kernel, 2 ** i, dropout)
            for i in range(len(channels)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.network:
            x = block(x, generator)
        return x


class TextEncoderTCN(nn.Module):
    """Word ids (B, T) -> embedding -> dropout -> TCN -> Linear(32), (B, T, 32)
    (reference model/HOP.py:18-48, multimodal_context_net.py:33-63). Children:
    `embedding`, `tcn.network.*`, `decoder`."""

    def __init__(self, n_words: int, embed_size: int = 300,
                 channels=(300, 300, 300, 300), kernel: int = 2,
                 dropout: float = 0.3, emb_dropout: float = 0.1):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.embedding = common.WordEmbedding(n_words, embed_size)
        self.tcn = TemporalConvNet(embed_size, channels, kernel, dropout)
        self.decoder = nn.Linear(channels[-1], 32)
        nn.init.normal_(self.decoder.weight, std=0.01)
        nn.init.zeros_(self.decoder.bias)

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = drop(self.embedding(tokens), self.emb_dropout if self.training else 0.0,
                   generator)
        y = self.tcn(emb.transpose(1, 2), generator).transpose(1, 2)
        return self.decoder(y)
