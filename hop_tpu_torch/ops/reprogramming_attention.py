"""Reprogramming cross-attention over shared prototypes: kernel K1, forward
and backward.

Replaces the TPU kernel `fused_reprogramming_attention` of
hop_tpu/ops/pallas_reprogramming.py (`_fwd_kernel` :110-127 called at
:207-220, `_bwd_kernel` :130-177 called at :227-251, custom VJP :187-195,
:223-254) with the CUDA kernels in csrc/reprogramming_attention.cu.

Computes out = (softmax(q kᵀ · scale) ∘ keep / (1 - rate)) v for q
(B, L, H, E) and prototype keys/values k, v (H, S, E) shared by the whole
batch; out (B, L, H, E) f32. The dropout mask `keep` is the hash of
ops/dropout.py, a function of (seed, b, h, l, s), so the kernel and the
plain version draw the same mask. The serving path runs it at rate 0.

On the card (HOP: B=256, L=34, H=8, E=128, S=1500) the (B, H, L, S) score
tensor is 418 MB in f32. The plain version writes it to device memory and
reads it back several times; the kernels keep each 64-key tile of scores in
shared memory: the forward folds them into a running (max, sum) softmax
and writes the per-row log-sum-exp, and the backward recomputes the
probabilities from it (flash-attention-2 shape, deterministic dk/dv; see
the .cu file). K and V are 3 MB each in bf16, too large for a block's
227 KB of shared memory, so each block streams them in 64-key tiles; what
bounds the kernels is the f32 FMA rate of their scalar products (forward
53.5 GFLOP, backward 187 GFLOP at that shape). Tensor-core products are for
a later change.

`plain_reprogramming_attention` is the JAX einsum path
(hop_tpu/models/reprogramming.py:61-65) in torch, with the same dropout;
`plain_reprogramming_attention_bwd` is the backward in the kernels'
algorithm (LSE recompute, delta = rowsum(dO ∘ O)). The wrappers take them
only for a tensor on the CPU; for a CUDA tensor they launch the kernels or
raise. On CUDA the operands (q, k, v, and dO in the backward) are cast to
bf16, as the TPU wrapper does (pallas_reprogramming.py:78-82, :248);
softmax, accumulation and the gradients are f32.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops.dropout import attention_keep, kernel_args

#: launches of the forward kernel since the last reset (a plain counter)
launches = 0
#: launches of the backward kernels (one per backward call)
bwd_launches = 0

#: query rows one block holds: nb samples of L rows each, nb = 68 // L
#: (must equal MAX_ROWS in csrc/reprogramming_attention.cu)
MAX_ROWS = 68
HEAD_DIM = 128


def plain_reprogramming_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float,
                                  rate: float = 0.0, seed: int = 0,
                                  with_lse: bool = False):
    """q (B, L, H, E); k, v (H, S, E) -> out (B, L, H, E) f32, and with
    `with_lse` also lse (B, L, H) f32, the log-sum-exp of the scaled scores."""
    B, L, H, _ = q.shape
    S = k.shape[1]
    s = torch.einsum("blhe,hse->bhls", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * attention_keep(seed, rate, B, L, H, S, q.device)
    out = torch.einsum("bhls,hse->blhe", p, v.float())
    if not with_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).transpose(1, 2).contiguous()


def plain_reprogramming_attention_bwd(q, k, v, out, lse, dout, scale: float,
                                      rate: float = 0.0, seed: int = 0):
    """Gradients (dq (B, L, H, E), dk, dv (H, S, E)), all f32, of `out` for
    the output gradient `dout`, recomputing p = exp(s - lse)."""
    B, L, H, _ = q.shape
    S = k.shape[1]
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("blhe,hse->bhls", qf, kf) * scale
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    delta = (do * out).sum(-1).transpose(1, 2)[..., None]       # (B, H, L, 1)
    dp = torch.einsum("blhe,hse->bhls", do, vf)
    pd = p
    if rate > 0.0:
        keep = attention_keep(seed, rate, B, L, H, S, q.device)
        pd = p * keep
        dp = dp * keep
    dv = torch.einsum("bhls,blhe->hse", pd, do)
    ds = p * (dp - delta)
    dq = torch.einsum("bhls,hse->blhe", ds, kf) * scale
    dk = torch.einsum("bhls,blhe->hse", ds, qf) * scale
    return dq, dk, dv


def _check(q, k, v):
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
    return B, L, H, E, S


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def reprogramming_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, scale: float,
                                rate: float = 0.0, seed: int = 0,
                                with_lse: bool = False):
    """The forward alone: out (B, L, H, E) f32, and lse (B, L, H) f32 with
    `with_lse`. On CUDA it launches the forward kernel once."""
    if q.device.type == "cpu":
        return plain_reprogramming_attention(q, k, v, scale, rate, seed,
                                             with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"reprogramming_attention: no kernel for device "
                         f"{q.device}")
    global launches
    B, L, H, E, S = _check(q, k, v)
    qb, kb, vb = _bf16(q), _bf16(k), _bf16(v)
    out = torch.empty((B, L, H, E), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, L, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_reprog_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, L, H, S, float(scale),
        *kernel_args(rate, seed), stream)
    _build.check(err, "hop_reprog_attn_fwd")
    launches += 1
    return (out, lse) if with_lse else out


def reprogramming_attention_bwd(q, k, v, out, lse, dout, scale: float,
                                rate: float = 0.0, seed: int = 0):
    """The backward alone: (dq, dk, dv) f32 from the forward's out and lse.
    On CUDA it launches the dq and dk/dv kernels (one count)."""
    if q.device.type == "cpu":
        return plain_reprogramming_attention_bwd(q, k, v, out, lse, dout,
                                                 scale, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"reprogramming_attention_bwd: no kernel for device "
                         f"{q.device}")
    global bwd_launches
    B, L, H, E, S = _check(q, k, v)
    for name, t, shape in (("out", out, (B, L, H, E)), ("dout", dout, (B, L, H, E)),
                           ("lse", lse, (B, L, H))):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name} must be {shape} on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    qb, kb, vb, gb = _bf16(q), _bf16(k), _bf16(v), _bf16(dout)
    outf = out.float().contiguous()
    lsef = lse.float().contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((B, L, H), **f32)
    dq = torch.empty((B, L, H, E), **f32)
    dk = torch.empty((H, S, E), **f32)
    dv = torch.empty((H, S, E), **f32)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_reprog_attn_bwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), outf.data_ptr(),
        gb.data_ptr(), lsef.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, L, H, S, float(scale),
        *kernel_args(rate, seed), stream)
    _build.check(err, "hop_reprog_attn_bwd")
    bwd_launches += 1
    return dq, dk, dv


class _ReprogrammingAttention(torch.autograd.Function):
    """Custom VJP of the TPU op (pallas_reprogramming.py:187-195, 223-254):
    the forward saves q, k, v, out and lse; the backward redraws the mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rate, seed):
        if q.device.type == "cuda":   # save the bf16 operands the kernels read
            q, k, v = _bf16(q), _bf16(k), _bf16(v)
        out, lse = reprogramming_attention_fwd(q, k, v, scale, rate, seed,
                                               with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = reprogramming_attention_bwd(q, k, v, out, lse, dout,
                                                 *ctx.args)
        return dq, dk, dv, None, None, None


def reprogramming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, rate: float = 0.0,
                            seed: int = 0) -> torch.Tensor:
    """softmax(q kᵀ · scale) [dropout(rate, seed)] v over S prototypes shared
    by the batch; differentiable in q, k and v.

    q: (B, L, H, E); k, v: (H, S, E). Returns (B, L, H, E) f32. Without a
    gradient to track it is the lean forward (no LSE)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _ReprogrammingAttention.apply(q, k, v, scale, rate, seed)
    return reprogramming_attention_fwd(q, k, v, scale, rate, seed)
