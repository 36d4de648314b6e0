"""Fused bidirectional GRU layer: kernel K2 forward.

Replaces the TPU kernel `gru_fused_layer` of hop_tpu/ops/pallas_gru_fused.py
(`_make_fwd_kernel`, :113-144, called at :147-195 without residuals) with
the CUDA kernel in csrc/gru_fused.cu: one GRU layer, both directions, the
gate input projections x · W_ih fused into the recurrence h · W_hh.

On the card (HOP head: T=34, B=256, I=992 in layer 0 and 700 after,
H=350) the recurrence is serial in T, so the kernel holds a batch tile's
h in shared memory and loops over T inside one block per (tile, direction).
The weights of a direction (5.7 MB at I=992) stay in L2 and are re-read
at every step; that traffic and the f32 FMAs of one SM per block bound it
(see the note in the .cu file).

`plain_gru_fused_layer` is the JAX scan math (hop_tpu/ops/gru.py:157-183)
in torch on the same (D, 3, I, H) weight layout. The wrapper takes it only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build

#: launches of the CUDA kernel since the last reset (a plain counter)
launches = 0


def plain_gru_fused_layer(x, wih, bih, whh, bhh, h0) -> torch.Tensor:
    """Same contract as `gru_fused_layer`, as per-step matmuls in torch."""
    T = x.shape[0]
    outs = []
    for d in range(wih.shape[0]):
        xp = torch.einsum("tbi,gih->gtbh", x, wih[d]) + bih[d][:, None]
        h = h0
        ys = [None] * T
        for t in (range(T) if d == 0 else reversed(range(T))):
            hp = torch.einsum("bk,gkh->gbh", h, whh[d]) + bhh[d]
            r = torch.sigmoid(xp[0, t] + hp[0])
            z = torch.sigmoid(xp[1, t] + hp[1])
            n = torch.tanh(xp[2, t] + r * hp[2])
            h = (1.0 - z) * n + z * h
            ys[t] = h
        outs.append(torch.stack(ys))
    return torch.stack(outs)


def gru_fused_layer(x: torch.Tensor, wih: torch.Tensor, bih: torch.Tensor,
                    whh: torch.Tensor, bhh: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """One (bi)directional GRU layer, projection and recurrence in one kernel.

    x:   (T, B, I) time-major layer input, shared by both directions.
    wih: (D, 3, I, H) per-gate input weights; bih: (D, 3, 1, H).
    whh: (D, 3, H, H) recurrent weights; bhh: (D, 3, 1, H).
    h0:  (B, H) initial state shared by the directions.
    Returns (D, T, B, H) f32 in natural time order for both directions.
    """
    if x.device.type == "cpu":
        return plain_gru_fused_layer(x, wih, bih, whh, bhh, h0)
    if x.device.type != "cuda":
        raise ValueError(f"gru_fused_layer: no kernel for device {x.device}")
    global launches
    T, B, I = x.shape
    D, _, _, H = wih.shape
    want = {"x": (T, B, I), "wih": (D, 3, I, H), "bih": (D, 3, 1, H),
            "whh": (D, 3, H, H), "bhh": (D, 3, 1, H), "h0": (B, H)}
    for name, t in zip(want, (x, wih, bih, whh, bhh, h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if D > 2 or H > 1024:
        raise ValueError(f"kernel takes D <= 2 and H <= 1024, got D={D}, H={H}")
    out = torch.empty((D, T, B, H), dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.hop_gru_fused_fwd(x.data_ptr(), wih.data_ptr(), bih.data_ptr(),
                                whh.data_ptr(), bhh.data_ptr(), h0.data_ptr(),
                                out.data_ptr(), T, B, I, H, D, stream)
    _build.check(err, "hop_gru_fused_fwd")
    launches += 1
    return out
