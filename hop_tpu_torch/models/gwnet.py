"""Graph WaveNet over the skeleton graph (port of hop_tpu/models/gwnet.py;
reference model/gwnet.py:8-249, adaptive-adjacency path).

Adaptive adjacency softmax(relu(E1 @ E2)), `blocks` x `layers` dilated
gated temporal convs (kernel (1, 2), dilations 1, 2, ...), each followed by
an order-2 diffusion GCN over the adaptive support, skip and residual
paths, BatchNorm (flax's rule in training: the running variance is
updated with the biased batch variance, `common.batch_norm`), and two 1x1
end convs. The layout is the reference's (B, C, N, T) with torch Conv2d
modules under the reference's names; the JAX package runs these convs in
XLA outside any Pallas kernel, so they stay plain PyTorch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.models.common import BatchNorm2d


def receptive_field(blocks: int, layers: int) -> int:
    """1 + what the (1, 2) convs with dilations 1, 2, 4, ... of every block
    take off the time axis."""
    return 1 + blocks * (2 ** layers - 1)


class _GCNMLP(nn.Module):
    """Holds the 1x1 conv at the reference's `gconv.{i}.mlp.mlp` path."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.mlp = nn.Conv2d(c_in, c_out, (1, 1))


class GCN(nn.Module):
    """h = mlp(concat[x, xA, xA^2, ...]) over channels (reference
    gwnet.py:24-46, support_len=1)."""

    def __init__(self, c_in: int, c_out: int, order: int = 2):
        super().__init__()
        self.order = order
        self.mlp = _GCNMLP((order + 1) * c_in, c_out)

    def forward(self, x: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
        outs = [x]
        xk = x
        for _ in range(self.order):
            xk = torch.einsum("bcvt,vw->bcwt", xk, support)
            outs.append(xk)
        return self.mlp.mlp(torch.cat(outs, dim=1))


class GraphWaveNet(nn.Module):
    """x: (B, in_dim, N, T) -> (B, out_dim, N, T - receptive_field + 1)."""

    def __init__(self, num_nodes: int, in_dim: int, out_dim: int,
                 residual_channels: int = 64, dilation_channels: int = 64,
                 skip_channels: int = 256, end_channels: int = 512,
                 blocks: int = 4, layers: int = 2,
                 node_emb_dim: int = 10, gcn_order: int = 2):
        super().__init__()
        self.receptive_field = receptive_field(blocks, layers)
        self.dilations = [2 ** i for _ in range(blocks) for i in range(layers)]
        self.nodevec1 = nn.Parameter(torch.randn(num_nodes, node_emb_dim))
        self.nodevec2 = nn.Parameter(torch.randn(node_emb_dim, num_nodes))
        self.start_conv = nn.Conv2d(in_dim, residual_channels, (1, 1))
        self.filter_convs = nn.ModuleList(
            nn.Conv2d(residual_channels, dilation_channels, (1, 2),
                      dilation=d) for d in self.dilations)
        self.gate_convs = nn.ModuleList(
            nn.Conv2d(residual_channels, dilation_channels, (1, 2),
                      dilation=d) for d in self.dilations)
        self.skip_convs = nn.ModuleList(
            nn.Conv2d(dilation_channels, skip_channels, (1, 1))
            for _ in self.dilations)
        self.gconv = nn.ModuleList(
            GCN(dilation_channels, residual_channels, gcn_order)
            for _ in self.dilations)
        self.bn = nn.ModuleList(BatchNorm2d(residual_channels)
                                for _ in self.dilations)
        self.end_conv_1 = nn.Conv2d(skip_channels, end_channels, (1, 1))
        self.end_conv_2 = nn.Conv2d(end_channels, out_dim, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[3] < self.receptive_field:
            x = F.pad(x, (self.receptive_field - x.shape[3], 0))
        adp = torch.softmax(torch.relu(self.nodevec1 @ self.nodevec2), dim=1)
        x = self.start_conv(x)
        skip = None
        for i in range(len(self.dilations)):
            residual = x
            x = (torch.tanh(self.filter_convs[i](residual))
                 * torch.sigmoid(self.gate_convs[i](residual)))
            s = self.skip_convs[i](x)
            skip = s if skip is None else s + skip[..., -s.shape[3]:]
            x = self.gconv[i](x, adp)
            x = x + residual[..., -x.shape[3]:]
            x = self.bn[i](x)
        out = torch.relu(skip)
        out = torch.relu(self.end_conv_1(out))
        return self.end_conv_2(out)
