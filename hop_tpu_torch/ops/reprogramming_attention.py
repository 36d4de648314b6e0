"""Reprogramming cross-attention over shared prototypes: kernel K1 forward.

Replaces the TPU kernel `fused_reprogramming_attention` of
hop_tpu/ops/pallas_reprogramming.py (`_fwd_kernel`, :110-127, called at
:207-220) with the CUDA kernel in csrc/reprogramming_attention.cu.

Computes out = softmax(q kᵀ · scale) v for q (B, L, H, E) and prototype
keys/values k, v (H, S, E) shared by the whole batch; out (B, L, H, E) f32.
The serving path runs it at rate 0 (no attention dropout).

On the card (HOP: B=256, L=34, H=8, E=128, S=1500) the (B, H, L, S) score
tensor is 418 MB in f32. The plain version writes it to device memory and
reads it back three times; the kernel keeps each 64-key tile of scores in
shared memory and folds it into a running (max, sum) softmax, so device
memory sees only q, k, v and out. K and V are 3 MB each in bf16, too large
for a block's 227 KB of shared memory, so each block streams them in
64-key tiles; what bounds the kernel is the f32 FMA rate of its scalar
products (53.5 GFLOP per call at that shape). Tensor-core products
(mma.sync, wgmma) are for a later change.

`plain_reprogramming_attention` is the JAX einsum path
(hop_tpu/models/reprogramming.py:61-65) in torch. The wrapper takes it
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build

#: launches of the CUDA kernel since the last reset (a plain counter)
launches = 0

#: query rows one block holds: nb samples of L rows each, nb = 68 // L
#: (must equal MAX_ROWS in csrc/reprogramming_attention.cu)
MAX_ROWS = 68
HEAD_DIM = 128


def plain_reprogramming_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, L, H, E); k, v (H, S, E) -> (B, L, H, E) f32."""
    s = torch.einsum("blhe,hse->bhls", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhls,hse->blhe", p, v.float())


def reprogramming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over S prototypes shared by the batch.

    q: (B, L, H, E); k, v: (H, S, E). Returns (B, L, H, E) f32. On CUDA the
    operands are cast to bf16 (as the TPU wrapper does, pallas_
    reprogramming.py:78-82); softmax and accumulation are f32.
    """
    if q.device.type == "cpu":
        return plain_reprogramming_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"reprogramming_attention: no kernel for device "
                         f"{q.device}")
    global launches
    B, L, H, E = q.shape
    S = k.shape[1]
    if k.shape != (H, S, E) or v.shape != (H, S, E):
        raise ValueError(f"k/v must be (H, S, E) = {(H, S, E)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if E != HEAD_DIM or L > MAX_ROWS:
        raise ValueError(f"kernel takes E == {HEAD_DIM} and L <= {MAX_ROWS}, "
                         f"got E={E}, L={L}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    qb = q.to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    out = torch.empty((B, L, H, E), dtype=torch.float32, device=q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_reprog_attn_fwd(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                                  out.data_ptr(), B, L, H, S, float(scale),
                                  stream)
    _build.check(err, "hop_reprog_attn_fwd")
    launches += 1
    return out
