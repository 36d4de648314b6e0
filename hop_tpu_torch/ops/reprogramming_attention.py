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
reads it back several times; the kernels never form it. What bounds the
forward is operations (53.5 GFLOP of bf16 products against 27 MB of
traffic), so it runs on the tensor cores: the keys are shared by the batch,
so a head's queries are one (B * L, E) matrix, cut into 64-row tiles
whatever L is; a block walks S in 64-key bf16 tiles (cp.async, two stages),
both products are `mma.sync` bf16 with f32 accumulators, the scores stay in
the accumulator registers for the online (max, sum) softmax, and
p * keep / (1 - rate) meets V as a hi + lo bf16 pair, so the result keeps
f32 accuracy. Where row tiles x heads would not fill the card (B = 1), S is
split across blocks and a second kernel combines the splits in order
(`split_count`, a function of the shape alone). The backward recomputes the
probabilities from the per-row log-sum-exp (flash-attention-2 shape) in two
kernels of the forward's block, every product `mma.sync` bf16: the dq
kernel walks the key tiles for a 64-row tile, dS meeting K as a hi + lo bf16
pair; the dk/dv kernel computes the transposed scores for a 64-key tile so
that (p ∘ keep)ᵀ and dSᵀ are born as the A fragments of dv and dk, over a
run of the query rows (`bwd_row_runs`, a function of the shape alone); the
runs' partial dk and dv are added in run order by a third kernel, so the
gradients repeat bit for bit without atomics. Operations bound it: five
products, 133.7 GFLOP at that shape (see the .cu file).

`plain_reprogramming_attention` is the JAX einsum path
(hop_tpu/models/reprogramming.py:61-65) in torch, with the same dropout;
`plain_reprogramming_attention_bwd` is the backward in the kernels'
algorithm (LSE recompute, delta = rowsum(dO ∘ O));
`tiled_reprogramming_attention` and `tiled_reprogramming_attention_bwd`
repeat the forward and backward kernels' arithmetic in torch for the CPU
tests. The wrappers take the plain versions
only for a tensor on the CPU; for a CUDA tensor they launch the kernels or
raise. On CUDA the operands (q, k, v, and dO in the backward) are cast to
bf16, as the TPU wrapper does (pallas_reprogramming.py:78-82, :248);
softmax, accumulation and the gradients are f32.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops.attention import split_bf16
from hop_tpu_torch.ops.dropout import attention_keep, kernel_args

#: launches of the forward kernel since the last reset (a plain counter)
launches = 0
#: launches of the backward kernels (one per backward call)
bwd_launches = 0

HEAD_DIM = 128
#: query rows and keys of one tile of the forward kernel, and the blocks that
#: fill the card (FWD_ROWS, TILE_S in csrc/reprogramming_attention.cu; the
#: SMs of an H100)
ROW_TILE = 64
KEY_TILE = 64
SM_COUNT = 132


def split_count(B: int, L: int, H: int, S: int) -> int:
    """Runs of key tiles the forward kernel cuts S into: 1 when the row
    tiles x heads fill the card, else enough runs to, every run holding the
    same number of tiles but the last."""
    blocks = -(-B * L // ROW_TILE) * H
    tiles = -(-S // KEY_TILE)
    if blocks >= SM_COUNT or tiles == 1:
        return 1
    per_run = -(-tiles // min(tiles, -(-SM_COUNT // blocks)))
    return -(-tiles // per_run)


#: runs the dk/dv kernel may cut the query rows into (each run's partial dk
#: and dv are H * S * E * 8 bytes of workspace)
MAX_ROW_RUNS = 16


def bwd_row_runs(B: int, L: int, H: int, S: int) -> int:
    """Runs of 64-row chunks the backward's dk/dv kernel cuts the B * L query
    rows into, each run a block of its own per (key tile, head): the fewest
    runs whose blocks fill their last wave (two blocks an SM) to 90%, else
    the count that fills it most; every run holds the same number of chunks
    but the last."""
    chunks = -(-B * L // ROW_TILE)
    tiles = -(-S // KEY_TILE) * H
    slots = 2 * SM_COUNT
    best, best_fill = 1, 0.0
    for want in range(1, min(chunks, MAX_ROW_RUNS) + 1):
        runs = -(-chunks // -(-chunks // want))
        blocks = tiles * runs
        fill = blocks / (-(-blocks // slots) * slots)
        if fill > best_fill:
            best, best_fill = runs, fill
        if fill >= 0.9:
            break
    return best


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


def tiled_reprogramming_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float,
                                  rate: float = 0.0, seed: int = 0,
                                  with_lse: bool = False, n_split=None):
    """`plain_reprogramming_attention`'s contract in the forward kernel's
    arithmetic, for tests: bf16 operands, S walked in 64-key tiles (the last
    one ragged) in `n_split` runs (`split_count` by default), an online
    max / sum in the exp2 domain, the dropped probabilities fed to the
    second product as hi + lo bf16, the runs combined in order."""
    B, L, H, E = q.shape
    S = k.shape[1]
    n_split = split_count(B, L, H, S) if n_split is None else n_split
    qf, kf, vf = (t.to(torch.bfloat16).float() for t in (q, k, v))
    keep = (attention_keep(seed, rate, B, L, H, S, q.device)
            if rate > 0.0 else None)
    tiles = -(-S // KEY_TILE)
    per_run = -(-tiles // n_split)
    log2e = 1.4426950408889634
    parts = []
    for run in range(n_split):
        m = q.new_full((B, H, L), float("-inf"), dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = q.new_zeros((B, H, L, E), dtype=torch.float32)
        for tile in range(run * per_run, min(tiles, (run + 1) * per_run)):
            s0, s1 = tile * KEY_TILE, min(S, (tile + 1) * KEY_TILE)
            sc = torch.einsum("blhe,hse->bhls", qf, kf[:, s0:s1]) * (scale * log2e)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            if keep is not None:
                p = p * keep[..., s0:s1]
            hi, lo = split_bf16(p)
            acc = acc * alpha[..., None] + (
                torch.einsum("bhls,hse->bhle", hi, vf[:, s0:s1])
                + torch.einsum("bhls,hse->bhle", lo, vf[:, s0:s1]))
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_run, l_run, acc_run in parts:
        w = torch.exp2(m_run - m)
        l = l + l_run * w
        acc = acc + acc_run * w[..., None]
    out = (acc / l[..., None]).transpose(1, 2).contiguous()
    if not with_lse:
        return out
    lse = (m + torch.log2(l)) * 0.6931471805599453
    return out, lse.transpose(1, 2).contiguous()


def tiled_reprogramming_attention_bwd(q, k, v, out, lse, dout, scale: float,
                                      rate: float = 0.0, seed: int = 0,
                                      n_runs=None):
    """`plain_reprogramming_attention_bwd`'s contract in the backward
    kernels' arithmetic, for tests: bf16 q, k, v and dO, p = exp2 from the
    saved lse, S walked in 64-key tiles for dq, dS and p ∘ keep fed to the
    second products as hi + lo bf16, dk and dv summed over `n_runs` runs of
    64-row chunks of the (B * L) query rows (`bwd_row_runs` by default) that
    are added in run order, dk scaled at the end."""
    B, L, H, E = q.shape
    S = k.shape[1]
    R = B * L
    n_runs = bwd_row_runs(B, L, H, S) if n_runs is None else n_runs
    qf, kf, vf, do = (t.to(torch.bfloat16).float() for t in (q, k, v, dout))
    log2e = 1.4426950408889634
    # (H, R, ...) views: a head's queries are one (B * L, E) matrix
    q2, do2 = (t.reshape(R, H, E).transpose(0, 1) for t in (qf, do))
    lse2 = lse.float().reshape(R, H).t() * log2e
    delta = (do * out.float()).sum(-1).reshape(R, H).t()
    keep = (attention_keep(seed, rate, B, L, H, S, q.device)
            .transpose(0, 1).reshape(H, R, S) if rate > 0.0 else None)
    sc = torch.einsum("hre,hse->hrs", q2, kf) * (scale * log2e)
    p = torch.exp2(sc - lse2[..., None])
    dp = torch.einsum("hre,hse->hrs", do2, vf)
    pd = p
    if keep is not None:
        pd, dp = p * keep, dp * keep
    ds = p * (dp - delta[..., None])
    ds_hi, ds_lo = split_bf16(ds)
    pd_hi, pd_lo = split_bf16(pd)
    dq = torch.zeros_like(q2)
    for s0 in range(0, S, KEY_TILE):
        tile = slice(s0, s0 + KEY_TILE)
        dq = dq + (torch.einsum("hrs,hse->hre", ds_hi[..., tile], kf[:, tile])
                   + torch.einsum("hrs,hse->hre", ds_lo[..., tile], kf[:, tile]))
    chunks = -(-R // ROW_TILE)
    per_run = -(-chunks // n_runs) * ROW_TILE
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0 in range(0, R, per_run):
        run = slice(r0, r0 + per_run)
        dv = dv + (torch.einsum("hrs,hre->hse", pd_hi[:, run], do2[:, run])
                   + torch.einsum("hrs,hre->hse", pd_lo[:, run], do2[:, run]))
        dk = dk + (torch.einsum("hrs,hre->hse", ds_hi[:, run], q2[:, run])
                   + torch.einsum("hrs,hre->hse", ds_lo[:, run], q2[:, run]))
    dq = (dq * scale).transpose(0, 1).reshape(B, L, H, E)
    return dq, dk * scale, dv


def _check(q, k, v):
    B, L, H, E = q.shape
    S = k.shape[1]
    if k.shape != (H, S, E) or v.shape != (H, S, E):
        raise ValueError(f"k/v must be (H, S, E) = {(H, S, E)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if E != HEAD_DIM:
        raise ValueError(f"kernel takes E == {HEAD_DIM}, got E={E}")
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
    `with_lse`. On CUDA it launches the forward kernel once (with the kernel
    that combines the key splits, where `split_count` is above 1)."""
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
    n_split = split_count(B, L, H, S)
    part_o = part_ml = None
    if n_split > 1:
        part_o = torch.empty((n_split, B, L, H, E), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((n_split, B, L, H, 2), dtype=torch.float32,
                              device=q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_reprog_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        part_o.data_ptr() if n_split > 1 else None,
        part_ml.data_ptr() if n_split > 1 else None, n_split, B, L, H, S,
        float(scale), *kernel_args(rate, seed), stream)
    _build.check(err, "hop_reprog_attn_fwd")
    launches += 1
    return (out, lse) if with_lse else out


def reprogramming_attention_bwd(q, k, v, out, lse, dout, scale: float,
                                rate: float = 0.0, seed: int = 0):
    """The backward alone: (dq, dk, dv) f32 from the forward's out and lse.
    On CUDA it launches the dq and dk/dv kernels and, where `bwd_row_runs`
    is above 1, the kernel that adds the runs (one count)."""
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
    n_runs = bwd_row_runs(B, L, H, S)
    part = torch.empty((n_runs, 2, H, S, E), **f32) if n_runs > 1 else None
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_reprog_attn_bwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), outf.data_ptr(),
        gb.data_ptr(), lsef.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), part.data_ptr() if n_runs > 1 else None,
        n_runs, B, L, H, S, float(scale), *kernel_args(rate, seed), stream)
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


@torch.library.custom_op("hop_tpu_torch::reprogramming_attention_fwd",
                         mutates_args=(), device_types="cpu")
def reprogramming_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, rate: float, seed: int) -> torch.Tensor:
    """The lean forward (no LSE) as a registered operator, so that
    `torch.export` keeps it as one node: on the CPU the plain version, on
    CUDA the kernel (`reprogramming_attention_fwd`), and for fake tensors
    the shape alone. No other device has an implementation."""
    return plain_reprogramming_attention(q, k, v, scale, rate, seed).contiguous()


@reprogramming_attention_op.register_kernel("cuda")
def _(q, k, v, scale, rate, seed):
    return reprogramming_attention_fwd(q, k, v, scale, rate, seed)


@reprogramming_attention_op.register_fake
def _(q, k, v, scale, rate, seed):
    return q.new_empty(q.shape, dtype=torch.float32)


def reprogramming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, rate: float = 0.0,
                            seed: int = 0) -> torch.Tensor:
    """softmax(q kᵀ · scale) [dropout(rate, seed)] v over S prototypes shared
    by the batch; differentiable in q, k and v.

    q: (B, L, H, E); k, v: (H, S, E). Returns (B, L, H, E) f32. Without a
    gradient to track it is the lean forward (no LSE), the registered
    operator `torch.ops.hop_tpu_torch.reprogramming_attention_fwd`."""
    _build.check_device(q, "reprogramming_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _ReprogrammingAttention.apply(q, k, v, scale, rate, seed)
    return torch.ops.hop_tpu_torch.reprogramming_attention_fwd(q, k, v, scale, rate, seed)
