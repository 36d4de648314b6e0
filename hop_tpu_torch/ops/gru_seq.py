"""GRU sequence kernel: kernel K6, forward only.

Replaces `pallas_gru_layer` (hop_tpu/ops/pallas_gru.py:54-100, kernel
`_gru_seq_kernel` :36-52) and the whole-stack forward `gru_forward_pallas`
(:103-125) with the CUDA entry in csrc/gru_seq.cu: one direction of one
layer from a batch-major projection x_proj (B, T, 3H), torch's gate order
r, z, n and torch's (3H, H) recurrent weights.

On the card it runs the forward recurrence kernels of K2 and K3 (W_hh on
the chip for the whole loop over T, the per-step product on the tensor
cores as 3×TF32; one block holding it in registers at H <= 64, a cluster
of eight blocks sharing it in shared memory above:
`gru_fused.recurrence_variant`), fed x_proj and the
batch-major output by their strides; the reverse direction is a reversed
time index in the kernel, where the TPU wrapper flipped x_proj and the
output. Any B is taken (the ragged tile is masked), so there is no
`batch_tile` argument; H is at most `MAX_H` (352), where JAX's kernel
states no limit. No `GRU` mode selects this kernel, as in the JAX package:
`gru_forward_seq` is its own entry. It is forward-only: the output carries
no graph.

`plain_gru_seq_layer` is the same function in torch; `resident_gru_seq_layer`
repeats the kernel's arithmetic (`gru_fused.resident_hidden_product`) for
the CPU tests. The wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Mapping

import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops import gru_fused

#: launches of the kernel since the last reset (a plain counter)
launches = 0
#: the widest layer the kernel takes
MAX_H = gru_fused.MAX_H


def plain_gru_seq_layer(x_proj, w_hh, b_hh, h0, reverse: bool = False):
    """Same contract as `gru_seq_layer`, as per-step matmuls in torch."""
    T = x_proj.shape[1]
    h = h0
    ys = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys, dim=1)


def resident_gru_seq_layer(x_proj, w_hh, b_hh, h0, reverse: bool = False):
    """`plain_gru_seq_layer`'s contract with the hidden product as the card's
    kernel at this H computes it (`gru_fused.resident_hidden_product`: 3xTF32
    chains in one block, or over a cluster's slices), for tests."""
    T, H = x_proj.shape[1], h0.shape[-1]
    w = w_hh.reshape(3, H, H).transpose(1, 2)          # [gate][k][j]
    b = b_hh.reshape(3, 1, H)
    h = h0
    ys = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
        hr, hz, hn = gru_fused.resident_hidden_product(h, w, b)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys, dim=1)


def _check(x_proj, w_hh, b_hh, h0):
    B, T, H3 = x_proj.shape
    H = H3 // 3
    want = {"x_proj": (B, T, 3 * H), "w_hh": (3 * H, H), "b_hh": (3 * H,),
            "h0": (B, H)}
    for name, t in zip(want, (x_proj, w_hh, b_hh, h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on {x_proj.device}")
    if H > MAX_H:
        raise ValueError(f"kernel takes H <= {MAX_H}, got H={H}")
    return B, T, H


@torch.no_grad()
def gru_seq_layer(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One GRU direction. x_proj (B, T, 3H) with b_ih already added (gate
    order r, z, n); w_hh (3H, H); b_hh (3H,); h0 (B, H); all contiguous f32,
    H <= MAX_H on every device. Returns the hidden states (B, T, H) in
    natural time order."""
    B, T, H = _check(x_proj, w_hh, b_hh, h0)
    if x_proj.device.type == "cpu":
        return plain_gru_seq_layer(x_proj, w_hh, b_hh, h0, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_seq_layer: no kernel for device {x_proj.device}")
    global launches
    # [gate][k][j], the layout the forward kernels read W_hh in
    w_t = w_hh.reshape(3, H, H).transpose(1, 2).contiguous()
    out = torch.empty((B, T, H), dtype=torch.float32, device=x_proj.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    err = lib.hop_gru_seq_fwd(x_proj.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(),
                              h0.data_ptr(), out.data_ptr(), T, B, H,
                              int(reverse), stream)
    _build.check(err, "hop_gru_seq_fwd")
    launches += 1
    return out


@torch.no_grad()
def gru_forward_seq(x: torch.Tensor, params: Mapping[str, torch.Tensor],
                    hidden_size: int, num_layers: int,
                    bidirectional: bool) -> torch.Tensor:
    """Whole stack forward, x (B, T, F) -> (B, T, D*H), from `ops.gru.GRU`'s
    parameters (`dict(gru.named_parameters())` or its state_dict: torch's
    names `weight_ih_l{k}`, ..., `_reverse` for the second direction). The
    input projections are plain matrix products; zero initial state, no
    dropout."""
    B = x.shape[0]
    h0 = torch.zeros((B, hidden_size), dtype=torch.float32, device=x.device)
    layer_in = x.float()
    for layer in range(num_layers):
        outs = []
        for sfx, reverse in (("", False), ("_reverse", True))[:1 + bidirectional]:
            w_ih, w_hh, b_ih, b_hh = (
                params[f"{name}_l{layer}{sfx}"].detach().float().contiguous()
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            x_proj = torch.addmm(b_ih, layer_in.reshape(-1, layer_in.shape[-1]),
                                 w_ih.t()).reshape(B, -1, 3 * hidden_size)
            outs.append(gru_seq_layer(x_proj, w_hh, b_hh, h0, reverse))
        layer_in = torch.cat(outs, dim=-1)
    return layer_in
