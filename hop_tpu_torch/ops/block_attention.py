"""Self-attention of the frozen backbone with samples stacked under a
block-diagonal mask: kernel K5, forward and backward.

Replaces the TPU kernel `block_attention` of
hop_tpu/ops/pallas_block_attention.py (`_fwd_kernel` :127-148 called at
:219-231, `_bwd_kernel` :150-192 called at :238-257, `_block_mask` :101-108,
`_probs` :110-114, custom VJP :201-209, :260) with the CUDA kernels in
csrc/block_attention.cu.

It computes the function of kernel K4 (ops/attention.py),

    out[b, :, h, :] = (softmax(q[b,:,h,:] k[b,:,h,:]^T * scale) o keep / (1 - rate)) v[b,:,h,:]

for q, k, v (B, T, H, D), by another formulation: a group of NB samples of
one head is stacked to M = NB * T rows, scores are formed against the M
stacked keys, and the block-diagonal mask (row // T == col // T) removes the
cross-sample products before an f32 softmax. The dropout mask is the hash of
ops/dropout.py with the key's index INSIDE ITS SAMPLE as the key coordinate,
so K5 draws K4's mask for the same seed, whatever the grouping.

On the card (HOP's backbone: B=256 or 1, T=34, H=12, D=64) the work is 0.9
GFLOP forward, 2.3 GFLOP backward, against 67 and 134 MB: the kernels are
bound by bytes. Stacking is what fills the tensor cores' 16-row tiles at
T=34: NB = 8 samples are M = 272 = 17 * 16 rows exactly, and a warp owns
16-row strips of queries. A strip touches at most two samples, so only the
key tiles of those samples (at most 6) are computed, masked inside the tile
and softmaxed in f32; the all-masked tiles are skipped. The TPU program
looped over the heads with an (M, M) f32 score matrix resident, which a
block's shared memory here cannot hold; a block here is one (group, head).
A ragged last group (B=250, B=1) is masked by row, never padded with -inf
rows.

The forward brings the group's Q, K and V rows of its head into shared
memory once by cp.async (bf16, 104 KB at M = 272, so two blocks share an
SM); nine warps take two strips each, and per strip the scores, the masked
softmax, the dropout and P stay in the `mma.sync` accumulators, P entering
P V as hi + lo bf16 (`register_block_attention` repeats the arithmetic in
torch for the tests). The backward stages the group's Q, K, V and dO once
(139 KB, one block an SM), a warp a strip, in two phases on the same
registers-only tiles: query strips recompute the probabilities, keep each
row's log-sum-exp and delta and write dq; then key strips recompute their
transposed tiles from those and write dk and dv (`strip_attention_bwd` in
ops/attention.py repeats it in torch; K4's backward is the same algorithm
with a sample as a group). Each output row has one owner: no atomics,
results repeat bit for bit.

Types on the card: the wrapper casts q, k, v (and dout) to bf16, as the TPU
caller did (`operand_dtype`, hop_tpu/models/bert.py:129-132). Scores and
softmax are f32. The tensor cores need bf16 operands for the products with
the probabilities and with ds: each f32 value goes in as the sum of two bf16
values (its rounding and the rounding of the remainder, two `mma` each), so
nothing is lost to a bf16 rounding as it was in the TPU kernel. out, dq, dk,
dv leave the kernels in f32, as the TPU kernel's did; the autograd function
returns the gradients in the operands' dtype (pallas_block_attention.py:256).

`plain_block_attention` and `plain_block_attention_bwd` go through the
stacked masked (M, M) scores too, so they are an oracle of the mask as well.
On the CPU they compute in the dtype they are given (f32 at least). The
wrappers take them only for a tensor on the CPU; for a CUDA tensor they
launch the kernels or raise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops.attention import (STRIP, bf16_operand, check_operands,
                                         compute_dtype, exp2_softmax, sample_span,
                                         split_bf16, strip_attention_bwd)
from hop_tpu_torch.ops.dropout import attention_keep, kernel_args

#: launches of the forward kernel since the last reset (a plain counter)
launches = 0
#: launches of the backward kernel
bwd_launches = 0

#: samples a group stacks at most, rows a group holds at most and the key
#: tiles a strip may need (must equal NB_MAX, MAX_ROWS and MAX_TILES in
#: csrc/block_attention.cu); a strip is STRIP rows (ops/attention.py)
NB_MAX = 8
MAX_ROWS = 272
MAX_TILES = 6


def group_size(B: int, T: int) -> int:
    """Samples stacked per group: 8, or fewer for a small batch or a long T."""
    return max(1, min(NB_MAX, B, MAX_ROWS // T))


@functools.lru_cache(maxsize=None)
def key_tiles(T: int, nb: int) -> int:
    """The most 16-key tiles one 16-row strip of a group of nb samples needs:
    the tiles that hold the keys of the samples its rows belong to."""
    return max(sample_span(r0, nb * T, T)[1] for r0 in range(0, nb * T, STRIP))


def _spans(B: int, nb: int):
    """(first sample, last sample + 1, samples per group): the full groups,
    then a ragged last group."""
    full = B // nb * nb
    if full:
        yield 0, full, nb
    if B > full:
        yield full, B, B - full


def _stack(t: torch.Tensor, m: int, dt: torch.dtype) -> torch.Tensor:
    """(G * m, T, H, D) -> (G, m * T, H, D) in the compute dtype."""
    n, T, H, D = t.shape
    return t.to(dt).reshape(n // m, m * T, H, D)


def _stacked_probs(qs, ks, scale: float, T: int, keep: Optional[torch.Tensor]):
    """Probabilities of stacked groups qs, ks (G, M, H, D): (p, keep), each
    (G, H, M, M), `keep` with ones off the diagonal blocks, or None."""
    G, M = qs.shape[:2]
    s = torch.einsum("gmhd,gnhd->ghmn", qs, ks) * scale
    sample = torch.arange(M, device=qs.device) // T
    same = sample[:, None] == sample[None, :]
    p = torch.softmax(s.masked_fill(~same, float("-inf")), dim=-1)
    if keep is None:
        return p, None
    m, H = M // T, keep.shape[1]
    blocks = keep.reshape(G, m, H, T, T)
    full = torch.ones((G, H, m, T, m, T), dtype=p.dtype, device=p.device)
    for i in range(m):
        full[:, :, i, :, i, :] = blocks[:, i]
    return p, full.reshape(G, H, M, M)


def _keep(q, rate: float, seed: int, dt):
    if rate == 0.0:
        return None
    B, T, H, _ = q.shape
    return attention_keep(seed, rate, B, T, H, T, q.device).to(dt)


def plain_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, rate: float = 0.0, seed: int = 0,
                          nb: Optional[int] = None) -> torch.Tensor:
    """q, k, v (B, T, H, D) -> out (B, T, H, D) f32 (f64 for f64 operands),
    through the stacked masked scores of groups of `nb` samples."""
    B, T, _, _ = q.shape
    nb = group_size(B, T) if nb is None else nb
    dt = compute_dtype(q)
    keep = _keep(q, rate, seed, dt)
    outs = []
    for b0, b1, m in _spans(B, nb):
        qs, ks, vs = (_stack(t[b0:b1], m, dt) for t in (q, k, v))
        p, kp = _stacked_probs(qs, ks, scale, T, None if keep is None else keep[b0:b1])
        if kp is not None:
            p = p * kp
        outs.append(torch.einsum("ghmn,gnhd->gmhd", p, vs).reshape(b1 - b0, *q.shape[1:]))
    return torch.cat(outs)


def plain_block_attention_bwd(q, k, v, dout, scale: float, rate: float = 0.0,
                              seed: int = 0, nb: Optional[int] = None):
    """(dq, dk, dv), each (B, T, H, D) f32 (f64 for f64 operands): the
    probabilities recomputed through the stacked masked scores, the mask
    redrawn."""
    B, T, _, _ = q.shape
    nb = group_size(B, T) if nb is None else nb
    dt = compute_dtype(q)
    keep = _keep(q, rate, seed, dt)
    grads = ([], [], [])
    for b0, b1, m in _spans(B, nb):
        qs, ks, vs, do = (_stack(t[b0:b1], m, dt) for t in (q, k, v, dout))
        p, kp = _stacked_probs(qs, ks, scale, T, None if keep is None else keep[b0:b1])
        dp = torch.einsum("gmhd,gnhd->ghmn", do, vs)
        pd = p
        if kp is not None:
            pd = p * kp
            dp = dp * kp
        # cross-sample entries have p == 0 and contribute nothing
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
        for out, g in zip(grads, (torch.einsum("ghmn,gnhd->gmhd", ds, ks),
                                  torch.einsum("ghmn,gmhd->gnhd", ds, qs),
                                  torch.einsum("ghmn,gmhd->gnhd", pd, do))):
            out.append(g.reshape(b1 - b0, *q.shape[1:]))
    return tuple(torch.cat(g) for g in grads)


def register_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, rate: float = 0.0, seed: int = 0,
                             nb: Optional[int] = None) -> torch.Tensor:
    """`plain_block_attention`'s contract in the forward kernel's arithmetic,
    for tests: bf16 operands stacked in groups of `nb` samples; per 16-row
    strip only the key tiles of its samples (`sample_span`), the rows and
    keys past the group's last read as its last row; the block-diagonal mask,
    the softmax in the exp2 domain and the dropout on the strip's scores; P
    fed to P V as hi + lo bf16 one 16-key tile at a time, added in order in
    f32. Returns f32 (B, T, H, D)."""
    B, T, H, D = q.shape
    nb = group_size(B, T) if nb is None else nb
    keep = _keep(q, rate, seed, torch.float32)
    dev = q.device
    out = []
    for b0, b1, m in _spans(B, nb):
        rows = m * T
        qs, ks, vs = (_stack(t[b0:b1].to(torch.bfloat16), m, torch.float32)
                      for t in (q, k, v))
        kp = (None if keep is None else
              keep[b0:b1].reshape(-1, m, H, T, T).transpose(1, 2))   # (G, H, m, T, T)
        res = qs.new_zeros(qs.shape)
        for r0 in range(0, rows, STRIP):
            c0, nt = sample_span(r0, rows, T)
            r = torch.arange(r0, r0 + STRIP, device=dev)
            c = torch.arange(c0, c0 + nt * STRIP, device=dev)
            ri, ci = r.clamp(max=rows - 1), c.clamp(max=rows - 1)
            first = (r // T * T)[:, None]        # the row's sample's first key
            allowed = (r < rows)[:, None] & (c[None] >= first) & (c[None] < first + T)
            p = exp2_softmax(torch.einsum("gmhd,gnhd->ghmn", qs[:, ri], ks[:, ci]),
                             allowed, scale)
            if kp is not None:
                p = p * kp[:, :, (ri // T)[:, None], (ri % T)[:, None],
                           (c[None] - (ri // T * T)[:, None]).clamp(0, T - 1)]
            hi, lo = split_bf16(p)
            acc = qs.new_zeros((qs.shape[0], H, STRIP, D))
            for t in range(nt):
                cols = slice(t * STRIP, (t + 1) * STRIP)
                vt = vs[:, ci[cols]]
                acc = acc + torch.einsum("ghmn,gnhd->ghmd", hi[..., cols], vt)
                acc = acc + torch.einsum("ghmn,gnhd->ghmd", lo[..., cols], vt)
            r1 = min(r0 + STRIP, rows)
            res[:, r0:r1] = acc[:, :, :r1 - r0].transpose(1, 2)
        out.append(res.reshape(b1 - b0, T, H, D))
    return torch.cat(out)


def register_block_attention_bwd(q, k, v, dout, scale: float, rate: float = 0.0,
                                 seed: int = 0, nb: Optional[int] = None):
    """`plain_block_attention_bwd`'s contract in the backward kernel's
    arithmetic, for tests: bf16 operands stacked in groups of `nb` samples
    (a ragged last group as the kernel takes it), then `strip_attention_bwd`
    (ops/attention.py). Returns f32 (dq, dk, dv), each (B, T, H, D)."""
    B, T, H, D = q.shape
    nb = group_size(B, T) if nb is None else nb
    keep = _keep(q, rate, seed, torch.float32)
    grads = ([], [], [])
    for b0, b1, m in _spans(B, nb):
        stacked = [_stack(t[b0:b1].to(torch.bfloat16), m, torch.float32)
                   for t in (q, k, v, dout)]
        kp = (None if keep is None else
              keep[b0:b1].reshape(-1, m, H, T, T).transpose(1, 2))   # (G, H, m, T, T)
        for out, g in zip(grads, strip_attention_bwd(*stacked, kp, T, scale)):
            out.append(g.reshape(b1 - b0, T, H, D))
    return tuple(torch.cat(g) for g in grads)


def _check(name: str, q, k, v, nb: Optional[int]):
    B, T, H, _ = check_operands(name, q, k, v, MAX_ROWS)
    nb = group_size(B, T) if nb is None else nb
    if not 1 <= nb <= NB_MAX or nb * T > MAX_ROWS or key_tiles(T, nb) > MAX_TILES:
        raise ValueError(f"{name}: a group of {nb} samples of T={T} rows needs "
                         f"{key_tiles(T, nb)} key tiles a strip and {nb * T} rows; "
                         f"the kernel takes {MAX_TILES} and {MAX_ROWS}")
    return B, T, H, nb


def block_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, rate: float = 0.0, seed: int = 0,
                        nb: Optional[int] = None) -> torch.Tensor:
    """The forward alone, f32. On CUDA it launches the forward kernel once;
    `nb` (default `group_size`) is the number of samples a group stacks."""
    if q.device.type == "cpu":
        return plain_block_attention(q, k, v, scale, rate, seed, nb)
    if q.device.type != "cuda":
        raise ValueError(f"block_attention: no kernel for device {q.device}")
    global launches
    B, T, H, nb = _check("block_attention", q, k, v, nb)
    qb, kb, vb = bf16_operand(q), bf16_operand(k), bf16_operand(v)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_block_attn_fwd(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                                 out.data_ptr(), B, T, H, nb, float(scale),
                                 *kernel_args(rate, seed), stream)
    _build.check(err, "hop_block_attn_fwd")
    launches += 1
    return out


def block_attention_bwd(q, k, v, dout, scale: float, rate: float = 0.0,
                        seed: int = 0, nb: Optional[int] = None):
    """The backward alone: (dq, dk, dv) f32 from q, k, v and dout. On CUDA it
    launches the backward kernel once."""
    if q.device.type == "cpu":
        return plain_block_attention_bwd(q, k, v, dout, scale, rate, seed, nb)
    if q.device.type != "cuda":
        raise ValueError(f"block_attention_bwd: no kernel for device {q.device}")
    global bwd_launches
    B, T, H, nb = _check("block_attention_bwd", q, k, v, nb)
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"block_attention_bwd: dout must be {tuple(q.shape)} on "
                         f"{q.device}, got {tuple(dout.shape)} on {dout.device}")
    qb, kb, vb, gb = (bf16_operand(t) for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hop_block_attn_bwd(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                                 gb.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), B, T, H, nb, float(scale),
                                 *kernel_args(rate, seed), stream)
    _build.check(err, "hop_block_attn_bwd")
    bwd_launches += 1
    return dq, dk, dv


class _BlockAttention(torch.autograd.Function):
    """Custom VJP of the TPU op (pallas_block_attention.py:201-260): the
    forward saves q, k, v and (scale, rate, seed) alone; the gradients come
    back in the operands' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rate, seed):
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        if q.device.type == "cuda":   # save the bf16 operands the kernels read
            q, k, v = bf16_operand(q), bf16_operand(k), bf16_operand(v)
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, rate, seed)
        return block_attention_fwd(q, k, v, scale, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        grads = block_attention_bwd(*ctx.saved_tensors, dout, *ctx.args)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None, None)


@torch.library.custom_op("hop_tpu_torch::block_attention_fwd", mutates_args=(),
                         device_types="cpu")
def block_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, rate: float, seed: int) -> torch.Tensor:
    """The forward as a registered operator, so that `torch.export` keeps it
    as one node: on the CPU the plain version, on CUDA the kernel
    (`block_attention_fwd`), and for fake tensors the shape alone. No other
    device has an implementation."""
    return plain_block_attention(q, k, v, scale, rate, seed).contiguous()


@block_attention_op.register_kernel("cuda")
def _(q, k, v, scale, rate, seed):
    return block_attention_fwd(q, k, v, scale, rate, seed)


@block_attention_op.register_fake
def _(q, k, v, scale, rate, seed):
    return q.new_empty(q.shape, dtype=torch.float32 if q.device.type == "cuda"
                       else compute_dtype(q))


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """softmax(q k^T * scale) [dropout(rate, seed)] v per (sample, head)
    through stacked groups; differentiable in q, k and v.

    q, k, v: (B, T, H, D). Returns (B, T, H, D) f32. Without a gradient to
    track it is the registered operator
    `torch.ops.hop_tpu_torch.block_attention_fwd`."""
    _build.check_device(q, "block_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockAttention.apply(q, k, v, scale, rate, seed)
    return torch.ops.hop_tpu_torch.block_attention_fwd(q, k, v, scale, rate, seed)
