"""Multi-layer (bi)directional GRU with torch.nn.GRU's parameters (port of
hop_tpu/ops/gru.py).

Parameters carry torch.nn.GRU's names and layout (`weight_ih_l{k}`,
`weight_hh_l{k}`, `bias_ih_l{k}`, `bias_hh_l{k}`, `_reverse` for the
backward direction; gates ordered r, z, n; two bias vectors), so weights
round-trip with the reference and with the JAX GRU 1:1. The stack runs
layer by layer, time-major in between, on one of two routes that share
those parameters (as the two Pallas routes do, JAX ops/gru.py:320-368):

  kernel="fused"  `gru_fused_layer` (kernel K2 on CUDA): the input
                  projection inside the recurrence kernel; the gate streams
                  never exist in device memory.
  kernel="stack"  one matrix product x · W_ihᵀ + b_ih per layer for both
                  directions and all gates, (T, B, D, 3, H), whose per-gate
                  slices `gru_stack` (kernel K3 on CUDA) takes as strided
                  views; `bf16_streams` stores that product in bf16 (the
                  recurrence and the h path stay f32).

`kernel` and `bf16_streams` take the place of the JAX package's
HOP_TPU_PALLAS_GRU (`fused` / `1`) and HOP_TPU_GRU_BF16_STREAMS; no
environment variable is read. The initial state is zero, as on the JAX
kernel paths. In training mode the layers' inputs after the first pass
through dropout at `dropout` (torch.nn.GRU(dropout=); JAX
ops/gru.py:336-338), the mask drawn from the generator the caller hands to
`forward`: 0.3 in the discriminator, 0 in the HOP head. The layers are
differentiable through K2's or K3's backward kernel.

`GRUCell` is a stack of single-step cells (JAX ops/gru.py:371-392) for the
seq2seq decoder, which runs one frame at a time: plain PyTorch, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.ops.dropout import dropout as drop
from hop_tpu_torch.ops.gru_fused import gru_fused_layer
from hop_tpu_torch.ops.gru_stack import gru_stack

KERNELS = ("fused", "stack")


class GRU(nn.Module):
    """batch_first GRU stack. forward(x (B, T, F)) returns (outputs (B, T,
    D*H), last_hidden (num_layers * D, B, H)) in torch's ordering."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0,
                 kernel: str = "fused", bf16_streams: bool = False):
        super().__init__()
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        self.kernel = kernel
        self.bf16_streams = bf16_streams
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

    def _params(self, name: str, layer: int):
        return [getattr(self, f"{name}_l{layer}{sfx}") for sfx in self.suffixes]

    def _hidden_weights(self, layer: int, dtype):
        """torch layout -> the kernels' stacked W_hh (D, 3, H, H), gate g
        mapping h -> h @ w[d, g], and b_hh (D, 3, 1, H)."""
        H = self.hidden_size
        whh = [w.reshape(3, H, H).transpose(1, 2)
               for w in self._params("weight_hh", layer)]
        bhh = [b.reshape(3, 1, H) for b in self._params("bias_hh", layer)]
        return [torch.stack(w).to(dtype).contiguous() for w in (whh, bhh)]

    def _fused_layer(self, x_tm, layer: int, h0):
        H = self.hidden_size
        wih = [w.reshape(3, H, -1).transpose(1, 2)
               for w in self._params("weight_ih", layer)]
        bih = [b.reshape(3, 1, H) for b in self._params("bias_ih", layer)]
        wih, bih = (torch.stack(w).to(h0.dtype).contiguous() for w in (wih, bih))
        whh, bhh = self._hidden_weights(layer, h0.dtype)
        return gru_fused_layer(x_tm, wih, bih, whh, bhh, h0)

    def _stack_layer(self, x_tm, layer: int, h0):
        """One product for every direction and gate, then the recurrence on
        its strided per-gate views (JAX `_pallas_layer_tm`, gru.py:96-130)."""
        T, B, F = x_tm.shape
        D, H = len(self.suffixes), self.hidden_size
        w_ih = torch.cat(self._params("weight_ih", layer)).to(h0.dtype)   # (D*3*H, F)
        b_ih = torch.cat(self._params("bias_ih", layer)).to(h0.dtype)
        proj = torch.addmm(b_ih, x_tm.reshape(T * B, F), w_ih.t())
        if self.bf16_streams:
            proj = proj.to(torch.bfloat16)
        xr, xz, xn = (g.permute(2, 0, 1, 3)
                      for g in proj.view(T, B, D, 3, H).unbind(dim=3))
        whh, bhh = self._hidden_weights(layer, h0.dtype)
        return gru_stack(xr, xz, xn, whh, bhh, h0)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        # f32, the kernels' type; an f64 input stays f64 (the plain versions
        # on the CPU take it; the kernels refuse it)
        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        h0 = torch.zeros((B, self.hidden_size), dtype=dtype, device=x.device)
        x_tm = x.to(dtype).transpose(0, 1).contiguous()      # (T, B, F)
        last = []
        for layer in range(self.num_layers):
            if layer > 0 and self.training:
                x_tm = drop(x_tm, self.dropout, generator)
            run = self._fused_layer if self.kernel == "fused" else self._stack_layer
            y = run(x_tm, layer, h0)                            # (D, T, B, H)
            x_tm = torch.cat(list(y), dim=-1).contiguous()
            last.append(y[0, -1])
            if len(self.suffixes) == 2:
                last.append(y[1, 0])
        return x_tm.transpose(0, 1), torch.stack(last)


class GRUCell(nn.Module):
    """`num_layers` single-step GRU cells stacked, under torch.nn.GRU's
    parameter names (`weight_ih_l{k}`, ...): the reference's decoder steps a
    unidirectional nn.GRU one frame at a time. forward(x (B, F), hidden
    (num_layers, B, H)) -> the new hidden (num_layers, B, H); layer k > 0
    reads layer k - 1's new state. Initialised as torch.nn.GRU."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        bound = 1.0 / math.sqrt(hidden_size)
        H = hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else H
            for name, shape in (("weight_ih", (3 * H, in_dim)),
                                ("weight_hh", (3 * H, H)),
                                ("bias_ih", (3 * H,)), ("bias_hh", (3 * H,))):
                p = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
                self.register_parameter(f"{name}_l{layer}", p)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        new = []
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = (getattr(self, f"{name}_l{layer}") for name in
                                      ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            h = hidden[layer]
            xr, xz, xn = torch.addmm(b_ih, x, w_ih.t()).chunk(3, dim=-1)
            hr, hz, hn = torch.addmm(b_hh, h, w_hh.t()).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            x = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
            new.append(x)
        return torch.stack(new)
