"""Self-attention of the frozen backbone, one (sample, head) at a time:
kernel K4, forward and backward.

Replaces the TPU kernel `fused_attention` of hop_tpu/ops/pallas_attention.py
(`_fwd_kernel` :126-135 called at :198-210, `_bwd_kernel` :137-161 called at
:217-233, custom VJP :187-195, :236) with the CUDA kernels in
csrc/attention.cu.

Computes, in the layout the QKV projections emit (no transpose on either
side),

    out[b, :, h, :] = (softmax(q[b,:,h,:] k[b,:,h,:]^T * scale) o keep / (1 - rate)) v[b,:,h,:]

for q, k, v (B, T, H, D). The dropout mask `keep` is the hash of
ops/dropout.py, a function of (seed, head, global query row b * T + tq, key
index inside the sample): the kernel, its backward, the plain version and
kernel K5 (ops/block_attention.py) all draw the same mask for one seed. The
TPU kernel seeded its generator per program, so its mask depended on the
blocking.

On the card (HOP's backbone: B=256 or 1, T=34, H=12, D=64) the work is 0.9
GFLOP forward and 2.3 GFLOP backward against 53 and 94 MB of operands and
results: the kernels are bound by bytes. Operands are read once, in 16-byte
pieces of the 128-byte head rows, and the probabilities never reach device
memory.

Both kernels run on the tensor cores, their operands brought by cp.async
into shared memory as bf16. The forward: one warp owns a (sample, head), a
block holds four heads of one sample; per 16-row tile of queries S = Q K^T
is bf16 `mma.sync` with f32 accumulators, the softmax and the dropout run
on the accumulators, and P enters O = P V as hi + lo bf16
(`tiled_fused_attention` repeats that arithmetic in torch for the tests).
The backward is K5's algorithm with a sample as a group of one, a block per
(sample, head) and a warp per 16-row strip (`strip_attention_bwd` repeats
it in torch): per query strip the probabilities are recomputed and the mask
redrawn, dP, delta and dS formed on the accumulators and dQ = dS K; per key
strip S^T and dP^T are recomputed with the keys as rows, from each query
row's log-sum-exp and delta, for dV = (p o keep)^T dO and dK = dS^T Q. Each
dq, dk, dv row has one owner, so nothing is summed across warps and the
results repeat bit for bit.

Types on the card: the wrapper casts q, k, v (and dout) to bf16, as the TPU
path ran under `compute_bf16`. Scores, softmax, ds and every accumulation
are f32, and the probabilities meet v at f32 accuracy (the TPU kernel
rounded the probabilities and ds to the operand type before their
products). out, dq, dk, dv leave the kernels in bf16, the operand type, as
the TPU kernel's did; `fused_attention` returns them in q's dtype.

`plain_fused_attention` is the einsum path of hop_tpu/models/bert.py:134-138
in torch with the hashed dropout; `plain_fused_attention_bwd` is the
backward in the kernel's algorithm (recompute, no log-sum-exp). On the CPU
they compute in the dtype they are given (f32 at least). The wrappers take
them only for a tensor on the CPU; for a CUDA tensor they launch the kernels
or raise.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops.dropout import attention_keep, kernel_args

#: launches of the forward kernel since the last reset (a plain counter)
launches = 0
#: launches of the backward kernel
bwd_launches = 0

#: the kernels take D == HEAD_DIM and T <= MAX_T (must equal HEAD_DIM and
#: MAX_T in csrc/attention.cu)
HEAD_DIM = 64
MAX_T = 64
LOG2E = 1.4426950408889634
#: rows of a strip, keys or queries of a tile of the backward (and of K5's
#: forward): STRIP in csrc/attention_tiles.cuh
STRIP = 16


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 for anything narrower, else the tensor's own dtype."""
    return t.dtype if t.dtype in (torch.float32, torch.float64) else torch.float32


def plain_fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, rate: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """q, k, v (B, T, H, D) -> out (B, T, H, D) in q's dtype."""
    B, T, H, _ = q.shape
    dt = compute_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * attention_keep(seed, rate, B, T, H, T, q.device).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(dt)).to(q.dtype)


def plain_fused_attention_bwd(q, k, v, dout, scale: float, rate: float = 0.0,
                              seed: int = 0):
    """(dq, dk, dv), each (B, T, H, D) in q's dtype, of `out` for the output
    gradient `dout`: the probabilities recomputed, the mask redrawn."""
    B, T, H, _ = q.shape
    dt = compute_dtype(q)
    qf, kf, vf, do = (t.to(dt) for t in (q, k, v, dout))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    pd = p
    if rate > 0.0:
        keep = attention_keep(seed, rate, B, T, H, T, q.device).to(dt)
        pd = p * keep
        dp = dp * keep
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, do)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def split_bf16(x: torch.Tensor):
    """x as hi + lo, its bf16 rounding and the rounding of the remainder."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def exp2_softmax(s: torch.Tensor, allowed: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernels' softmax over the last axis where `allowed`: exp2 of the
    scores times scale * log2(e) less the row's max, times the reciprocal of
    the row's sum; 0 where not allowed and in a row with nothing allowed."""
    s = torch.where(allowed, s * (scale * LOG2E), float("-inf"))
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m))
    total = e.sum(-1, keepdim=True)
    return e * torch.where(total > 0, 1.0 / total, 0.0)


def tiled_fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, rate: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """`plain_fused_attention`'s contract in the forward kernel's arithmetic,
    for tests: bf16 operands; queries in 16-row tiles and keys in whole
    16-key steps, the rows and keys past T read as row T - 1 (as the
    kernel's clamped ldmatrix addresses do) and those keys masked; the
    softmax in the exp2 domain; the dropped probabilities fed to P V as hi +
    lo bf16, one 16-key step at a time, added in order in f32. Returns f32
    (B, T, H, D): the kernel rounds it to bf16 once."""
    B, T, H, D = q.shape
    TP = -(-T // 16) * 16
    idx = torch.arange(TP, device=q.device).clamp(max=T - 1)
    qf, kf, vf = (t.to(torch.bfloat16).float()[:, idx] for t in (q, k, v))
    p = exp2_softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf),
                     torch.arange(TP, device=q.device) < T, scale)
    if rate > 0.0:
        keep = attention_keep(seed, rate, B, T, H, T, q.device)
        p = p * torch.nn.functional.pad(keep, (0, TP - T, 0, TP - T))
    hi, lo = split_bf16(p)
    out = q.new_zeros((B, H, TP, D), dtype=torch.float32)
    for j0 in range(0, TP, 16):
        vs = vf[:, j0:j0 + 16]
        out = out + torch.einsum("bhqk,bkhd->bhqd", hi[..., j0:j0 + 16], vs)
        out = out + torch.einsum("bhqk,bkhd->bhqd", lo[..., j0:j0 + 16], vs)
    return out[:, :, :T].transpose(1, 2).contiguous()


def sample_span(r0: int, rows: int, T: int) -> tuple:
    """(first row, 16-row tiles) of the samples that rows [r0, r0 + 16) of a
    group of `rows` rows (samples of T rows stacked) belong to, widened to
    whole tiles (`sample_span` in csrc/attention_tiles.cuh): the keys of a
    query strip, or the queries of a key strip."""
    first = r0 // T * T
    last = (min(r0 + STRIP, rows) - 1) // T * T + T
    return first // STRIP * STRIP, -(-last // STRIP) - first // STRIP


def strip_attention_bwd(qs, ks, vs, dos, keep, T: int, scale: float):
    """The backward kernels' arithmetic (K4's and K5's, one algorithm) in
    torch, for tests. qs, ks, vs, dos: (G, M, H, D) f32 groups of M = m * T
    stacked rows (K4: one sample a group), bf16-rounded; keep: (G, H, m, T, T)
    keep factors of each sample, or None. Returns (dq, dk, dv), each (G, M,
    H, D) f32.

    Phase 1, per 16-row query strip: the key tiles of its samples
    (`sample_span`), rows and keys past the group's last read as its last
    row; S, the block-diagonal mask and the undropped softmax in the exp2
    domain, each row's log2-sum-exp2; dP o keep, delta, dS = p (dP o keep -
    delta) scale; dQ = dS K with dS as hi + lo bf16, one 16-key tile at a
    time, hi then lo, added in order in f32. Phase 2, per 16-key strip: per
    16-query tile of its samples S^T and dP^T, p = exp2(S^T scale log2(e) -
    lse) where query and key share a sample and 0 elsewhere, p o keep and
    dS^T; dV and dK as dQ, one query tile at a time."""
    G, M, H, D = qs.shape
    dev = qs.device
    c = scale * LOG2E
    lse = qs.new_zeros((G, H, M))
    delta = qs.new_zeros((G, H, M))
    grads = [torch.zeros_like(qs) for _ in range(3)]

    def factor(rows, cols):
        """keep at query rows x key columns of the group, 1 off a sample"""
        if keep is None:
            return 1.0
        local = (cols[None] - (rows // T * T)[:, None]).clamp(0, T - 1)
        return keep[:, :, (rows // T)[:, None], (rows % T)[:, None], local]

    def products(acc, w, rows):
        """acc + w (G, H, 16, 16 n) times `rows` (G, 16 n, H, D), a 16-row
        tile of them at a time, hi then lo"""
        hi, lo = split_bf16(w)
        for t in range(w.shape[-1] // STRIP):
            cols = slice(t * STRIP, (t + 1) * STRIP)
            acc = acc + torch.einsum("ghmn,gnhd->ghmd", hi[..., cols], rows[:, cols])
            acc = acc + torch.einsum("ghmn,gnhd->ghmd", lo[..., cols], rows[:, cols])
        return acc

    def store(out, r0, acc):
        r1 = min(r0 + STRIP, M)
        out[:, r0:r1] = acc[:, :, :r1 - r0].transpose(1, 2)

    for r0 in range(0, M, STRIP):           # phase 1: query strips
        c0, nt = sample_span(r0, M, T)
        r = torch.arange(r0, r0 + STRIP, device=dev)
        cols = torch.arange(c0, c0 + nt * STRIP, device=dev)
        ri, ci = r.clamp(max=M - 1), cols.clamp(max=M - 1)
        first = (r // T * T)[:, None]
        allowed = (r < M)[:, None] & (cols[None] >= first) & (cols[None] < first + T)
        s = torch.where(allowed, torch.einsum("gmhd,gnhd->ghmn", qs[:, ri], ks[:, ci]) * c,
                        float("-inf"))
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isinf(m), 0.0, m)
        e = torch.exp2(s - m)
        total = e.sum(-1, keepdim=True)
        p = e * torch.where(total > 0, 1.0 / total, 0.0)
        dp = torch.einsum("gmhd,gnhd->ghmn", dos[:, ri], vs[:, ci])
        dp = dp * torch.where(allowed, factor(ri, cols), 1.0)
        d = (p * dp).sum(-1, keepdim=True)
        valid = r[r < M]
        lse[:, :, valid] = (m + torch.log2(total))[..., :len(valid), 0]
        delta[:, :, valid] = d[..., :len(valid), 0]
        store(grads[0], r0, products(qs.new_zeros((G, H, STRIP, D)),
                                     p * (dp - d) * scale, ks[:, ci]))
    for j0 in range(0, M, STRIP):           # phase 2: key strips
        c0, nt = sample_span(j0, M, T)
        j = torch.arange(j0, j0 + STRIP, device=dev)
        jj = j.clamp(max=M - 1)
        key_sample = torch.where(j < M, j // T, -1)
        dk, dv = (qs.new_zeros((G, H, STRIP, D)) for _ in range(2))
        for t in range(nt):
            qc = torch.arange(c0 + t * STRIP, c0 + (t + 1) * STRIP, device=dev)
            qi = qc.clamp(max=M - 1)
            valid = key_sample[:, None] == torch.where(qc < M, qc // T, -2)[None]
            st = torch.einsum("gmhd,gnhd->ghmn", ks[:, jj], qs[:, qi])
            dpt = torch.einsum("gmhd,gnhd->ghmn", vs[:, jj], dos[:, qi])
            p = torch.where(valid, torch.exp2(st * c - lse[:, :, None, qi]), 0.0)
            kf = torch.where(valid, factor(qi, jj).transpose(-1, -2) if keep is not None
                             else 1.0, 1.0)
            dv = products(dv, p * kf, dos[:, qi])
            dk = products(dk, p * (dpt * kf - delta[:, :, None, qi]) * scale, qs[:, qi])
        store(grads[1], j0, dk)
        store(grads[2], j0, dv)
    return tuple(grads)


def tiled_fused_attention_bwd(q, k, v, dout, scale: float, rate: float = 0.0,
                              seed: int = 0):
    """`plain_fused_attention_bwd`'s contract in the backward kernel's
    arithmetic, for tests (`strip_attention_bwd` with each sample a group of
    one). Returns f32 (dq, dk, dv), each (B, T, H, D): the kernel rounds them
    to bf16 once."""
    B, T, H, _ = q.shape
    bf = [t.to(torch.bfloat16).float() for t in (q, k, v, dout)]
    keep = (None if rate == 0.0 else
            attention_keep(seed, rate, B, T, H, T, q.device).reshape(B, H, 1, T, T))
    return strip_attention_bwd(*bf, keep, T, scale)


def check_operands(name: str, q, k, v, max_t: int):
    """(B, T, H, D) of three same-shape tensors on one device that the CUDA
    kernels take; raises on anything else."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, T, H, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if D != HEAD_DIM or not 1 <= T <= max_t or B < 1 or not 1 <= H <= 65535:
        raise ValueError(f"{name}: kernel takes D == {HEAD_DIM} and T <= {max_t}, "
                         f"got (B, T, H, D) = {(B, T, H, D)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k and v must be on one device")
    return B, T, H, D


def bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous bf16 at a 32-byte aligned address (no copy when it is so)."""
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, rate: float = 0.0,
                        seed: int = 0) -> torch.Tensor:
    """The forward alone. On CUDA it launches the forward kernel once and
    returns bf16; on the CPU the plain version, in q's dtype."""
    if q.device.type == "cpu":
        return plain_fused_attention(q, k, v, scale, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    global launches
    B, T, H, _ = check_operands("fused_attention", q, k, v, MAX_T)
    qb, kb, vb = bf16_operand(q), bf16_operand(k), bf16_operand(v)
    out = torch.empty_like(qb)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_attn_fwd(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                           out.data_ptr(), B, T, H, float(scale),
                           *kernel_args(rate, seed), stream)
    _build.check(err, "hop_attn_fwd")
    launches += 1
    return out


def fused_attention_bwd(q, k, v, dout, scale: float, rate: float = 0.0,
                        seed: int = 0):
    """The backward alone: (dq, dk, dv) from q, k, v and dout. On CUDA it
    launches the backward kernel once and returns bf16; on the CPU the plain
    version, in q's dtype."""
    if q.device.type == "cpu":
        return plain_fused_attention_bwd(q, k, v, dout, scale, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: no kernel for device {q.device}")
    global bwd_launches
    B, T, H, _ = check_operands("fused_attention_bwd", q, k, v, MAX_T)
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"fused_attention_bwd: dout must be {tuple(q.shape)} on "
                         f"{q.device}, got {tuple(dout.shape)} on {dout.device}")
    qb, kb, vb, gb = (bf16_operand(t) for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(qb) for _ in range(3))
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_attn_bwd(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                           gb.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), B, T, H, float(scale),
                           *kernel_args(rate, seed), stream)
    _build.check(err, "hop_attn_bwd")
    bwd_launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Custom VJP of the TPU op (pallas_attention.py:187-236): the forward
    saves q, k, v and (scale, rate, seed) alone; the backward recomputes the
    probabilities and redraws the mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rate, seed):
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        if q.device.type == "cuda":   # save the bf16 operands the kernels read
            q, k, v = bf16_operand(q), bf16_operand(k), bf16_operand(v)
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, rate, seed)
        return fused_attention_fwd(q, k, v, scale, rate, seed).to(ctx.dtypes[0])

    @staticmethod
    def backward(ctx, dout):
        grads = fused_attention_bwd(*ctx.saved_tensors, dout, *ctx.args)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None, None)


@torch.library.custom_op("hop_tpu_torch::fused_attention_fwd", mutates_args=(),
                         device_types="cpu")
def fused_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, rate: float, seed: int) -> torch.Tensor:
    """The forward as a registered operator, so that `torch.export` keeps it
    as one node: on the CPU the plain version (q's dtype), on CUDA the
    kernel (`fused_attention_fwd`, bf16), and for fake tensors the shape
    alone. No other device has an implementation."""
    return plain_fused_attention(q, k, v, scale, rate, seed).contiguous()


@fused_attention_op.register_kernel("cuda")
def _(q, k, v, scale, rate, seed):
    return fused_attention_fwd(q, k, v, scale, rate, seed)


@fused_attention_op.register_fake
def _(q, k, v, scale, rate, seed):
    return q.new_empty(q.shape, dtype=torch.bfloat16 if q.device.type == "cuda"
                       else q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """softmax(q k^T * scale) [dropout(rate, seed)] v per (sample, head);
    differentiable in q, k and v.

    q, k, v: (B, T, H, D). Returns (B, T, H, D) in q's dtype. Without a
    gradient to track it is the registered operator
    `torch.ops.hop_tpu_torch.fused_attention_fwd`."""
    _build.check_device(q, "fused_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttention.apply(q, k, v, scale, rate, seed)
    return torch.ops.hop_tpu_torch.fused_attention_fwd(
        q, k, v, scale, rate, seed).to(q.dtype)
