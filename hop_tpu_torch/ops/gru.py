"""Multi-layer (bi)directional GRU with torch.nn.GRU's parameters (port of
hop_tpu/ops/gru.py).

Parameters carry torch.nn.GRU's names and layout (`weight_ih_l{k}`,
`weight_hh_l{k}`, `bias_ih_l{k}`, `bias_hh_l{k}`, `_reverse` for the
backward direction; gates ordered r, z, n; two bias vectors), so weights
round-trip with the reference and with the JAX GRU 1:1. The stack runs
layer by layer through `gru_fused_layer` (kernel K2 on CUDA), time-major
in between. The initial state is zero, as on the JAX fused path. In
training mode the layers' inputs after the first pass through dropout at
`dropout` (torch.nn.GRU(dropout=); JAX ops/gru.py:336-338), the mask drawn
from the generator the caller hands to `forward`: 0.3 in the
discriminator, 0 in the HOP head. The layers are differentiable through
K2's backward kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.ops.dropout import dropout as drop
from hop_tpu_torch.ops.gru_fused import gru_fused_layer


class GRU(nn.Module):
    """batch_first GRU stack. forward(x (B, T, F)) returns (outputs (B, T,
    D*H), last_hidden (num_layers * D, B, H)) in torch's ordering."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.dropout = dropout
        self.num_layers = num_layers
        self.suffixes = ["", "_reverse"] if bidirectional else [""]
        bound = 1.0 / math.sqrt(hidden_size)
        H = hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else H * len(self.suffixes)
            for sfx in self.suffixes:
                for name, shape in (("weight_ih", (3 * H, in_dim)),
                                    ("weight_hh", (3 * H, H)),
                                    ("bias_ih", (3 * H,)),
                                    ("bias_hh", (3 * H,))):
                    p = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
                    self.register_parameter(f"{name}_l{layer}{sfx}", p)

    def _layer_weights(self, layer: int):
        """torch layout -> the kernel's stacked (D, 3, ·, H) layout."""
        H = self.hidden_size
        wih, bih, whh, bhh = [], [], [], []
        for sfx in self.suffixes:
            w_ih = getattr(self, f"weight_ih_l{layer}{sfx}")
            w_hh = getattr(self, f"weight_hh_l{layer}{sfx}")
            wih.append(w_ih.reshape(3, H, -1).transpose(1, 2))
            whh.append(w_hh.reshape(3, H, H).transpose(1, 2))
            bih.append(getattr(self, f"bias_ih_l{layer}{sfx}").reshape(3, 1, H))
            bhh.append(getattr(self, f"bias_hh_l{layer}{sfx}").reshape(3, 1, H))
        return [torch.stack(w).float().contiguous() for w in (wih, bih, whh, bhh)]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        h0 = torch.zeros((B, self.hidden_size), dtype=torch.float32,
                         device=x.device)
        x_tm = x.float().transpose(0, 1).contiguous()      # (T, B, F)
        last = []
        for layer in range(self.num_layers):
            if layer > 0 and self.training:
                x_tm = drop(x_tm, self.dropout, generator)
            wih, bih, whh, bhh = self._layer_weights(layer)
            y = gru_fused_layer(x_tm, wih, bih, whh, bhh, h0)   # (D, T, B, H)
            x_tm = torch.cat(list(y), dim=-1).contiguous()
            last.append(y[0, -1])
            if len(self.suffixes) == 2:
                last.append(y[1, 0])
        return x_tm.transpose(0, 1), torch.stack(last)
