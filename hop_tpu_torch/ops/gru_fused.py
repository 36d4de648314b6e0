"""Fused bidirectional GRU layer: kernel K2, forward and backward.

Replaces the TPU kernel `gru_fused_layer` of hop_tpu/ops/pallas_gru_fused.py
(`_make_fwd_kernel` :113-144 called at :147-195, `_make_bwd_kernel`
:202-310 called at :313-373, custom VJP `_fused_fwd`/`_fused_bwd`
:397-418) with the CUDA kernels in csrc/gru_fused.cu: one GRU layer, both
directions, from the layer's input x and its weights, behind one call.

On the card (HOP head: T=34, B=256, I=992 in layer 0 and 700 after,
H=350; discriminator: T=28, H=64, I=8 then 128) the layer is bound by
operations (49.1 GFLOP of f32 work at I=992). The TPU kernel computed the
input projection x · W_ih inside its loop over T to keep the projected
gates out of device memory; here they are 73 MB, a few hundredths of a
millisecond of traffic, while the projection inside the serial loop re-read
W_ih from L2 at every step. So the forward entry runs two phases on one
stream: (A) a hand-written tensor-core product xp = x · W_ih + b_ih over
all T * B rows at f32 accuracy (each operand split into TF32 hi + lo, three
`mma.sync` a product, f32 accumulators) into a workspace (T, B, D, 3, H),
and (B) the recurrence h · W_hh over T inside one kernel, W_hh resident on
the chip for the whole loop (the kernels the stack route runs), the
per-step product h · W_hh on the tensor cores (3×TF32): at a narrow layer
(the discriminator's H=64) one block holds the direction's W_hh and 8 batch
rows; at a wide one (H=350) a thread-block cluster of eight blocks shares
it, each block computing its 44 hidden units and exchanging slices of h
through distributed shared memory (`recurrence_variant`, a function of H
alone, the same for the backward). In
training the forward also writes the gates r, z, n and
hnb = h W_hh[n] + b_hh[n]. The
backward runs the serial dh recurrence in one kernel of the same kind (W_hh
resident in a block or a cluster, the carry's product on the tensor cores,
gate-gradient streams out) and everything else (dx, dW_ih, dW_hh: ≈85 of the ≈98 GFLOP
of a head layer at I=992) as three products of one hand-written GEMM on the
tensor cores at f32 accuracy, the projection's 3×TF32 `mma.sync` tile: the
operands are staged as they lie (W_ih in place for dx, x and hprev read
transposed from shared memory for dW), a block owns an output tile (128 ×
128, or 64 × 64 at the discriminator's narrow shapes) and a slice of K;
slices are at most 2304 deep, because the tensor cores' f32 accumulation
truncates, and where the tiles are too few to fill the card there are more
of them (`gemm_plan`, a function of the shape alone), summed in slice order
by a second kernel; the bias gradients are ordered column sums. No atomics,
so the gradients repeat bit for bit (see the .cu files).

`plain_gru_fused_layer` is the JAX scan math (hop_tpu/ops/gru.py:157-183)
in torch on the same (D, 3, I, H) weight layout; `plain_gru_fused_layer_bwd`
is the backward in the kernels' split (gate grads by a reversed loop, then
products and sums); `two_phase_gru_fused_layer` and
`sliced_gru_fused_layer_bwd` repeat the forward and backward kernels'
arithmetic in torch for the CPU tests, the recurrences' through
`resident_hidden_product` and `resident_carry_product` (3×TF32 chains,
in one block or over a cluster's slices). The wrappers take the plain
versions only for a tensor on the CPU; for a CUDA tensor they launch the
kernels or raise.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build

#: launches of the forward kernel since the last reset (a plain counter)
launches = 0
#: launches of the backward kernels (one per backward call)
bwd_launches = 0


def plain_gru_fused_layer(x, wih, bih, whh, bhh, h0,
                          with_residuals: bool = False):
    """Same contract as `gru_fused_layer_fwd`, as per-step matmuls in torch."""
    T = x.shape[0]
    outs, res = [], []
    for d in range(wih.shape[0]):
        xp = torch.einsum("tbi,gih->gtbh", x, wih[d]) + bih[d][:, None]
        h = h0
        ys = [None] * T
        gates = [None] * T
        for t in (range(T) if d == 0 else reversed(range(T))):
            hp = torch.einsum("bk,gkh->gbh", h, whh[d]) + bhh[d]
            r = torch.sigmoid(xp[0, t] + hp[0])
            z = torch.sigmoid(xp[1, t] + hp[1])
            n = torch.tanh(xp[2, t] + r * hp[2])
            h = (1.0 - z) * n + z * h
            ys[t] = h
            gates[t] = torch.stack([r, z, n, hp[2]])
        outs.append(torch.stack(ys))
        res.append(torch.stack(gates, dim=1))              # (4, T, B, H)
    out = torch.stack(outs)
    if not with_residuals:
        return out
    r, z, n, hnb = torch.stack(res, dim=1)                 # each (D, T, B, H)
    return out, r, z, n, hnb


#: a block's most shared memory on the card
SMEM_BLOCK_MAX = 232448
#: the recurrences (RC_CL, RC_ROWS, RC_MAX_SL, RC_NARROW_H, RC_SMALL_B,
#: FWD_ONE_DIR_NT in csrc/gru_common.cuh): blocks of a cluster, batch rows of
#: a cluster of the backward (and of the forward at two directions), most
#: hidden units of a block, the widest layer of the one-block instances, the
#: largest batch of one row tile, the forward's row tiles at one direction
CLUSTER_BLOCKS = 8
CLUSTER_ROWS = 40
CLUSTER_MAX_UNITS = 44
MAX_H = CLUSTER_BLOCKS * CLUSTER_MAX_UNITS
NARROW_H = 64
SMALL_B = 8
ONE_DIR_ROW_TILES = 3


def recurrence_variant(H: int) -> str:
    """Which recurrence kernel runs at hidden width H, forward and backward
    alike, as the host side chooses it (`launch_fwd_recurrence`,
    `launch_bwd_recurrence` in csrc/gru_common.cuh), from H alone: "block"
    where one block holds the direction's W_hh (up to NARROW_H: the
    discriminator's 64), "cluster" where eight blocks share it (up to MAX_H:
    the head's 350). Both run the per-step product on the tensor cores."""
    if H < 1 or H > MAX_H:
        raise ValueError(f"the GRU kernels take 1 <= H <= {MAX_H}, got H={H}")
    return "block" if H <= NARROW_H else "cluster"


def forward_cluster_rows(B: int, D: int) -> int:
    """Batch rows of one cluster of the forward recurrence at a wide layer,
    from (B, D) alone (`fwd_row_tiles` in csrc/gru_common.cuh): one 8-row tile
    for a batch of at most SMALL_B rows, ONE_DIR_ROW_TILES tiles at one
    direction (B = 256: 11 clusters where 40 rows would leave 7 on 56 SMs),
    five at two (B = 256: 14 clusters, one wave)."""
    if B <= SMALL_B:
        return 8
    return 8 * (ONE_DIR_ROW_TILES if D == 1 else CLUSTER_ROWS // 8)


def _pad4mod8(x: int) -> int:
    return (x + 3) // 8 * 8 + 4


def _slice_ld(k: int) -> int:
    return -(-k // 8) * 8 + 4


def recurrence_smem_bytes(H: int, backward: bool = False) -> int:
    """Shared memory of a block of the kernel `recurrence_variant` names (the
    forward's cluster at CLUSTER_ROWS rows), the wrapper's copy of the host
    side's sizes."""
    blocks = 1 if recurrence_variant(H) == "block" else CLUSTER_BLOCKS
    rows = 8 if blocks == 1 else CLUSTER_ROWS
    sl = -(-H // blocks)
    if not backward:
        if blocks == 1:
            # W_hh in registers; two h tiles NARROW_H deep and the halves'
            # exchange (static, whatever H is)
            return (2 * 8 * _slice_ld(NARROW_H) + (NARROW_H // 16) * 2 * 3 * 2 * 32) * 4
        lda = _pad4mod8(blocks * sl + (8 - sl % 8) % 8)
        return (3 * sl * lda + 3 * rows * _slice_ld(sl)) * 4
    k3 = 3 * sl
    lda = _pad4mod8(blocks * k3 + (8 - k3 % 8) % 8)
    return (sl * lda + (1 if blocks == 1 else 2) * rows * _slice_ld(k3)) * 4


def _split_tf32(x: torch.Tensor):
    """x as hi + lo in TF32 (10 mantissa bits), as the projection kernel
    splits it: hi is x rounded to nearest, ties away from zero, with its low
    13 mantissa bits cleared; lo is the remainder x - hi with its low 13
    bits dropped, as the tensor core reads it."""
    def bits(t):
        return t.contiguous().view(torch.int32)
    hi = ((bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, (bits(x - hi) & ~0x1FFF).view(torch.float32)


def _tf32x3(pairs) -> torch.Tensor:
    """The sum of a @ b over `pairs` as the recurrence kernels' tensor-core
    chains sum it: each operand split into TF32 hi + lo, the three terms
    (lo hi, hi lo, hi hi) each summed over the pairs in order in a chain of
    its own, then added, the small terms first."""
    terms = [None, None, None]
    for a, b in pairs:
        a_hi, a_lo = _split_tf32(a)
        b_hi, b_lo = _split_tf32(b)
        for i, part in enumerate((a_lo @ b_hi, a_hi @ b_lo, a_hi @ b_hi)):
            terms[i] = part if terms[i] is None else terms[i] + part
    return (terms[0] + terms[1]) + terms[2]


def _unit_slices(H: int, blocks: int):
    """The hidden units of each block of a cluster: `blocks` slices of
    ceil(H / blocks) units, the last ones short or empty."""
    sl = -(-H // blocks)
    return [slice(min(c * sl, H), min((c + 1) * sl, H)) for c in range(blocks)]


def _own_and_peers(H: int):
    """For each block of a cluster with units of its own: its slice and its
    peers' slices in the order it multiplies them, from its own rank upwards."""
    slices = _unit_slices(H, CLUSTER_BLOCKS)
    for c, own in enumerate(slices):
        if own.stop > own.start:
            order = [slices[(c + i) % CLUSTER_BLOCKS] for i in range(CLUSTER_BLOCKS)]
            yield own, [p for p in order if p.stop > p.start]


def resident_hidden_product(h, w, bias):
    """h (B, H) . w (3, H, H) + bias (3, 1, H) -> (3, B, H) in the forward
    recurrence kernel's arithmetic at this H: 3xTF32 products, each term
    summed over K in a chain of its own, the bias added last; in the
    one-block kernel over each half of K (NARROW_H / 2 deep), half 0 + half
    1, and in the cluster for each block's units over the peers' slices of h
    in the block's order."""
    H = h.shape[-1]
    if recurrence_variant(H) == "block":
        half = NARROW_H // 2
        out = _tf32x3([(h[:, :half], w[:, :half])])
        if H > half:
            out = out + _tf32x3([(h[:, half:], w[:, half:])])
        return out + bias
    out = h.new_zeros((3, h.shape[0], H))
    for own, peers in _own_and_peers(H):
        out[:, :, own] = _tf32x3((h[:, p], w[:, p, own]) for p in peers)
    return out + bias


def resident_gru_recurrence(xr, xz, xn, w, b, h0, with_residuals: bool = False):
    """`ops.gru_stack.plain_gru_stack`'s contract (streams (D, T, B, H), w
    (D, 3, H, H), b (D, 3, 1, H), h0 (B, H)) with the hidden product as the
    forward kernel chosen for this H computes it, for tests."""
    D, T = xr.shape[:2]
    xr, xz, xn = (t.to(h0.dtype) for t in (xr, xz, xn))
    outs, res = [], []
    for d in range(D):
        h = h0
        ys, gates = [None] * T, [None] * T
        for t in (range(T) if d == 0 else reversed(range(T))):
            hp = resident_hidden_product(h, w[d], b[d])
            r = torch.sigmoid(xr[d, t] + hp[0])
            z = torch.sigmoid(xz[d, t] + hp[1])
            n = torch.tanh(xn[d, t] + r * hp[2])
            h = (1.0 - z) * n + z * h
            ys[t] = h
            gates[t] = torch.stack([r, z, n, hp[2]])
        outs.append(torch.stack(ys))
        res.append(torch.stack(gates, dim=1))
    out = torch.stack(outs)
    if not with_residuals:
        return out
    r, z, n, hnb = torch.stack(res, dim=1)
    return out, r, z, n, hnb


def resident_carry_product(d_hid, whh):
    """sum over gate, k of d_hid[b, gate, k] whh[gate][j][k] -> (B, H) in the
    backward recurrence kernel's arithmetic at this H: 3xTF32 chains over
    K = 3 H laid out gate by gate in the one-block kernel, and in the cluster
    over the peers' slices of the units (a slice's three gates side by
    side)."""
    B, _, H = d_hid.shape
    if recurrence_variant(H) == "block":
        return _tf32x3([(d_hid.reshape(B, 3 * H),
                         whh.permute(0, 2, 1).reshape(3 * H, H))])
    out = d_hid.new_zeros((B, H))
    for own, peers in _own_and_peers(H):
        out[:, own] = _tf32x3(
            (d_hid[:, :, p].reshape(B, -1),                           # [b, (gate, k)]
             whh[:, own, p].permute(0, 2, 1).reshape(-1, own.stop - own.start))
            for p in peers)
    return out


def two_phase_gru_fused_layer(x, wih, bih, whh, bhh, h0,
                              with_residuals: bool = False):
    """`plain_gru_fused_layer`'s contract in the forward kernels' two phases,
    for tests: the projection xp (T, B, D, 3, H) once, each operand split
    into TF32 hi + lo and the product summed from three (lo hi, hi lo,
    hi hi), then the recurrence from xp with the hidden product as the
    kernel for this H sums it (`resident_hidden_product`)."""
    T = x.shape[0]
    D = wih.shape[0]
    x_hi, x_lo = _split_tf32(x)
    w_hi, w_lo = _split_tf32(wih)
    xp = (torch.einsum("tbi,dgih->tbdgh", x_lo, w_hi)
          + torch.einsum("tbi,dgih->tbdgh", x_hi, w_lo)
          + torch.einsum("tbi,dgih->tbdgh", x_hi, w_hi)) + bih[:, :, 0]
    outs, res = [], []
    for d in range(D):
        h = h0
        ys, gates = [None] * T, [None] * T
        for t in (range(T) if d == 0 else reversed(range(T))):
            hp = resident_hidden_product(h, whh[d], bhh[d])
            r = torch.sigmoid(xp[t, :, d, 0] + hp[0])
            z = torch.sigmoid(xp[t, :, d, 1] + hp[1])
            n = torch.tanh(xp[t, :, d, 2] + r * hp[2])
            h = (1.0 - z) * n + z * h
            ys[t] = h
            gates[t] = torch.stack([r, z, n, hp[2]])
        outs.append(torch.stack(ys))
        res.append(torch.stack(gates, dim=1))
    out = torch.stack(outs)
    if not with_residuals:
        return out
    r, z, n, hnb = torch.stack(res, dim=1)
    return out, r, z, n, hnb


def plain_carry_product(d_hid, whh):
    """A step's d_hid (B, 3, H) through W_hh (3, H, H) to the dh carry (B, H)."""
    return torch.einsum("bgk,gjk->bj", d_hid, whh)


def _gate_grad_streams(g, r, z, n, hnb, hprev, whh, carry=plain_carry_product):
    """The serial part of the backward: the gate-gradient streams d_in =
    (dr, dz, dn) and d_hid = (dr, dz, dn * r), each (T, B, D, 3, H), and the
    dh carry after the last step, (D, B, H). `carry` takes a step's d_hid
    (B, 3, H) through W_hh (3, H, H) to the carry (B, H)."""
    D, T, B, H = g.shape
    d_in = g.new_zeros((T, B, D, 3, H))
    d_hid = g.new_zeros((T, B, D, 3, H))
    dh0 = g.new_zeros((D, B, H))
    for d in range(D):
        dh = g.new_zeros((B, H))
        for t in (reversed(range(T)) if d == 0 else range(T)):
            gt = g[d, t] + dh
            dn = gt * (1.0 - z[d, t]) * (1.0 - n[d, t] * n[d, t])
            dz = gt * (hprev[d, t] - n[d, t]) * z[d, t] * (1.0 - z[d, t])
            dr = dn * hnb[d, t] * r[d, t] * (1.0 - r[d, t])
            d_in[t, :, d] = torch.stack([dr, dz, dn], dim=1)
            d_hid[t, :, d] = torch.stack([dr, dz, dn * r[d, t]], dim=1)
            dh = gt * z[d, t] + carry(d_hid[t, :, d], whh[d])
        dh0[d] = dh
    return d_in, d_hid, dh0


def plain_gru_fused_layer_bwd(g, x, r, z, n, hnb, hprev, wih, whh):
    """Same contract as `gru_fused_layer_bwd`, in torch."""
    d_in, d_hid, dh0 = _gate_grad_streams(g, r, z, n, hnb, hprev, whh)
    dx = torch.einsum("tbdgj,dgij->tbi", d_in, wih)
    dwih = torch.einsum("tbi,tbdgj->dgij", x, d_in)
    dwhh = torch.einsum("dtbk,tbdgj->dgkj", hprev, d_hid)
    dbih = d_in.sum(dim=(0, 1))[:, :, None]
    dbhh = d_hid.sum(dim=(0, 1))[:, :, None]
    return dx, dwih, dbih, dwhh, dbhh, dh0.sum(0)


#: the backward GEMM's constants (MK, MIN_SLICE, MAX_SLICE, SM_COUNT in
#: csrc/gru_common.cuh): depth of a k tile, least and most K of one block's
#: accumulator chain, the SMs of an H100
GEMM_K_TILE = 32
GEMM_MIN_SLICE = 256
GEMM_MAX_SLICE = 2304
SM_COUNT = 132


def gemm_plan(M: int, N: int, K: int, nseg: int, nz: int):
    """(big tile?, K slices, k tiles a slice) of the backward's GEMM for nz
    products (M, N) over nseg segments of K, as the kernel's host side
    chooses them (`gemm_plan` in csrc/gru_common.cuh), from the shape alone:
    the 128 x 128 tile where both sides fill it and its blocks can fill the
    card, else 64 x 64; slices between GEMM_MIN_SLICE and GEMM_MAX_SLICE
    deep; where the tiles alone do not fill one wave of blocks, the fewest
    slices whose blocks fill their last wave to 90%, else the count that
    fills it most."""
    n_kt = nseg * -(-K // GEMM_K_TILE)
    lo = -(-n_kt * GEMM_K_TILE // GEMM_MAX_SLICE)
    hi = max(lo, min(64, n_kt * GEMM_K_TILE // GEMM_MIN_SLICE))

    def tiles(b):
        return -(-M // b) * -(-N // b) * nz
    big = M >= 128 and N >= 128 and tiles(128) * hi >= SM_COUNT
    t = tiles(128) if big else tiles(64)
    slots = SM_COUNT * (2 if big else 3)
    best = lo
    if t < slots:
        best_fill = 0.0
        for ks in range(lo, hi + 1):
            blocks = t * ks
            fill = blocks / (-(-blocks // slots) * slots)
            if fill > best_fill:
                best, best_fill = ks, fill
            if fill >= 0.9:
                break
    per_slice = -(-n_kt // best)
    return big, -(-n_kt // per_slice), per_slice


def bwd_workspace_floats(T: int, B: int, I: int, H: int, D: int) -> int:
    """Floats of split-K workspace the backward's three products need: the
    wrapper's copy of `hop_gru_fused_bwd_workspace`."""
    def floats(M, N, K, nseg, nz):
        ks = gemm_plan(M, N, K, nseg, nz)[1]
        return 0 if ks == 1 else nz * ks * M * N
    return max(floats(T * B, I, H, 3 * D, 1), floats(I, H, T * B, 1, 3 * D),
               floats(H, H, T * B, 1, 3 * D))


def _sliced_tf32_matmul(a, b, nseg: int = 1):
    """a (..., M, K') . b (..., K', N) as the backward's GEMM sums it: K' is
    nseg segments of K end to end, each operand split into TF32 hi + lo, a
    product summed from three (lo hi, hi lo, hi hi) inside a slice of k
    tiles, the slices added in order."""
    M, N = a.shape[-2], b.shape[-1]
    K = a.shape[-1] // nseg
    nz = max(a.shape[:-2].numel(), b.shape[:-2].numel())
    _, ksplit, per_slice = gemm_plan(M, N, K, nseg, nz)
    seg_tiles = -(-K // GEMM_K_TILE)

    def tile_start(kt):      # element of K' where k tile kt begins
        seg, tile = divmod(kt, seg_tiles)
        return min(seg * K + tile * GEMM_K_TILE, nseg * K)
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    out = None
    for s in range(ksplit):
        k = slice(tile_start(s * per_slice),
                  tile_start(min((s + 1) * per_slice, nseg * seg_tiles)))
        part = (a_lo[..., k] @ b_hi[..., k, :] + a_hi[..., k] @ b_lo[..., k, :]
                + a_hi[..., k] @ b_hi[..., k, :])
        out = part if out is None else out + part
    return out


def sliced_gru_fused_layer_bwd(g, x, r, z, n, hnb, hprev, wih, whh):
    """`plain_gru_fused_layer_bwd`'s contract in the backward kernels'
    arithmetic, for tests: the gate-gradient streams with the carry's
    product as the recurrence kernel for this H sums it
    (`resident_carry_product`), then dx, dW_ih and dW_hh as 3xTF32 products
    over ordered K slices (`gemm_plan`)."""
    D, T, B, H = g.shape
    I = x.shape[-1]
    TB = T * B
    d_in, d_hid, dh0 = _gate_grad_streams(g, r, z, n, hnb, hprev, whh,
                                          carry=resident_carry_product)
    # dx: K runs over the 3 D (direction, gate) segments of H
    dx = _sliced_tf32_matmul(d_in.reshape(TB, 3 * D * H),
                             wih.transpose(2, 3).reshape(3 * D * H, I),
                             nseg=3 * D).reshape(T, B, I)
    # dW: 3 D products over K = T * B, each stream column block its own B
    streams = [s.reshape(TB, D, 3, H).permute(1, 2, 0, 3) for s in (d_in, d_hid)]
    dwih = _sliced_tf32_matmul(x.reshape(TB, I).t(), streams[0])
    dwhh = _sliced_tf32_matmul(hprev.reshape(D, 1, TB, H).transpose(2, 3), streams[1])
    dbih = d_in.sum(dim=(0, 1))[:, :, None]
    dbhh = d_hid.sum(dim=(0, 1))[:, :, None]
    return dx, dwih, dbih, dwhh, dbhh, dh0.sum(0)


def _check(x, wih, bih, whh, bhh, h0):
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
    if D > 2 or H > MAX_H:
        raise ValueError(f"kernel takes D <= 2 and H <= {MAX_H}, got D={D}, H={H}")
    return T, B, I, H, D


def gru_fused_layer_fwd(x: torch.Tensor, wih: torch.Tensor, bih: torch.Tensor,
                        whh: torch.Tensor, bhh: torch.Tensor, h0: torch.Tensor,
                        with_residuals: bool = False):
    """One (bi)directional GRU layer, projection and recurrence in one call
    (on CUDA one launch count: the projection kernel, then the recurrence).

    x:   (T, B, I) time-major layer input, shared by both directions.
    wih: (D, 3, I, H) per-gate input weights; bih: (D, 3, 1, H).
    whh: (D, 3, H, H) recurrent weights; bhh: (D, 3, 1, H).
    h0:  (B, H) initial state shared by the directions.
    Returns (D, T, B, H) f32 in natural time order for both directions, and
    with `with_residuals` also the gates r, z, n and hnb, each (D, T, B, H).
    """
    if x.device.type == "cpu":
        return plain_gru_fused_layer(x, wih, bih, whh, bhh, h0, with_residuals)
    if x.device.type != "cuda":
        raise ValueError(f"gru_fused_layer: no kernel for device {x.device}")
    global launches
    T, B, I, H, D = _check(x, wih, bih, whh, bhh, h0)
    n_out = 5 if with_residuals else 1
    outs = [torch.empty((D, T, B, H), dtype=torch.float32, device=x.device)
            for _ in range(n_out)]
    res_ptrs = [o.data_ptr() for o in outs[1:]] or [None] * 4
    # the projected gates, scratch between the entry's two phases
    xp = torch.empty((T, B, D, 3, H), dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.hop_gru_fused_fwd(x.data_ptr(), wih.data_ptr(), bih.data_ptr(),
                                whh.data_ptr(), bhh.data_ptr(), h0.data_ptr(),
                                xp.data_ptr(), outs[0].data_ptr(), *res_ptrs,
                                T, B, I, H, D, stream)
    _build.check(err, "hop_gru_fused_fwd")
    launches += 1
    return tuple(outs) if with_residuals else outs[0]


def gru_fused_layer_bwd(g, x, r, z, n, hnb, hprev, wih, whh):
    """Gradients of one layer from its residuals (`_fused_bwd`,
    pallas_gru_fused.py:403-415): g, r, z, n, hnb, hprev (D, T, B, H) with
    hprev the state each step started from; x (T, B, I); wih, whh as in
    the forward. Returns (dx (T, B, I) summed over the directions, dwih,
    dbih, dwhh, dbhh, dh0 (B, H) summed over the directions)."""
    if g.device.type == "cpu":
        return plain_gru_fused_layer_bwd(g, x, r, z, n, hnb, hprev, wih, whh)
    if g.device.type != "cuda":
        raise ValueError(f"gru_fused_layer_bwd: no kernel for device {g.device}")
    global bwd_launches
    D, T, B, H = g.shape
    I = x.shape[-1]
    for name, t, shape in (("g", g, (D, T, B, H)), ("r", r, (D, T, B, H)),
                           ("z", z, (D, T, B, H)), ("n", n, (D, T, B, H)),
                           ("hnb", hnb, (D, T, B, H)), ("hprev", hprev, (D, T, B, H)),
                           ("x", x, (T, B, I)), ("wih", wih, (D, 3, I, H)),
                           ("whh", whh, (D, 3, H, H))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != g.device:
            raise ValueError(f"{name} must be float32 {shape} on {g.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if D > 2 or H > MAX_H:
        raise ValueError(f"kernel takes D <= 2 and H <= {MAX_H}, got D={D}, H={H}")
    g, x, r, z, n, hnb, hprev = (t.contiguous() for t in (g, x, r, z, n, hnb, hprev))
    # the recurrence and the dx product read W_hh and W_ih as they lie
    wih, whh = wih.contiguous(), whh.contiguous()
    f32 = dict(dtype=torch.float32, device=g.device)
    d_in = torch.empty((T, B, D, 3, H), **f32)
    d_hid = torch.empty((T, B, D, 3, H), **f32)
    dx = torch.empty((T, B, I), **f32)
    dwih = torch.empty((D, 3, I, H), **f32)
    dbih = torch.empty((D, 3, 1, H), **f32)
    dwhh = torch.empty((D, 3, H, H), **f32)
    dbhh = torch.empty((D, 3, 1, H), **f32)
    dh0 = torch.empty((D, B, H), **f32)
    lib = _build.load()
    n_work = lib.hop_gru_fused_bwd_workspace(T, B, I, H, D)
    work = torch.empty((n_work,), **f32) if n_work else None
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.hop_gru_fused_bwd(
        g.data_ptr(), x.data_ptr(), r.data_ptr(), z.data_ptr(), n.data_ptr(),
        hnb.data_ptr(), hprev.data_ptr(), wih.data_ptr(), whh.data_ptr(),
        d_in.data_ptr(), d_hid.data_ptr(), work.data_ptr() if n_work else None,
        dx.data_ptr(), dwih.data_ptr(), dbih.data_ptr(), dwhh.data_ptr(),
        dbhh.data_ptr(), dh0.data_ptr(), T, B, I, H, D, stream)
    _build.check(err, "hop_gru_fused_bwd")
    bwd_launches += 1
    return dx, dwih, dbih, dwhh, dbhh, dh0.sum(0)


def hprev_of(h_seq: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The state each step started from, (D, T, B, H), in natural time order
    (pallas_gru_fused.py:406-411)."""
    prev = [torch.cat([h0[None], h_seq[0, :-1]])]
    if h_seq.shape[0] == 2:
        prev.append(torch.cat([h_seq[1, 1:], h0[None]]))
    return torch.stack(prev)


class _GRUFusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wih, bih, whh, bhh, h0):
        h_seq, r, z, n, hnb = gru_fused_layer_fwd(x, wih, bih, whh, bhh, h0,
                                                  with_residuals=True)
        ctx.save_for_backward(x, r, z, n, hnb, h_seq, wih, whh, h0)
        return h_seq

    @staticmethod
    def backward(ctx, g):
        x, r, z, n, hnb, h_seq, wih, whh, h0 = ctx.saved_tensors
        return gru_fused_layer_bwd(g.contiguous(), x, r, z, n, hnb,
                                   hprev_of(h_seq, h0), wih, whh)


@torch.library.custom_op("hop_tpu_torch::gru_fused_layer_fwd", mutates_args=(),
                         device_types="cpu")
def gru_fused_layer_op(x: torch.Tensor, wih: torch.Tensor, bih: torch.Tensor,
                       whh: torch.Tensor, bhh: torch.Tensor,
                       h0: torch.Tensor) -> torch.Tensor:
    """The lean forward (no residuals) as a registered operator, so that
    `torch.export` keeps it as one node: on the CPU the plain version, on
    CUDA the kernel (`gru_fused_layer_fwd`), and for fake tensors the shape
    alone. No other device has an implementation."""
    return plain_gru_fused_layer(x, wih, bih, whh, bhh, h0)


@gru_fused_layer_op.register_kernel("cuda")
def _(x, wih, bih, whh, bhh, h0):
    return gru_fused_layer_fwd(x, wih, bih, whh, bhh, h0)


@gru_fused_layer_op.register_fake
def _(x, wih, bih, whh, bhh, h0):
    D, T, B, H = wih.shape[0], x.shape[0], x.shape[1], wih.shape[-1]
    return x.new_empty((D, T, B, H))


def gru_fused_layer(x: torch.Tensor, wih: torch.Tensor, bih: torch.Tensor,
                    whh: torch.Tensor, bhh: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """`gru_fused_layer_fwd`'s contract, differentiable in every operand.
    Without a gradient to track it is the lean forward (no residuals), the
    registered operator `torch.ops.hop_tpu_torch.gru_fused_layer_fwd`."""
    args = (x, wih, bih, whh, bhh, h0)
    _build.check_device(x, "gru_fused_layer")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GRUFusedLayer.apply(*args)
    return torch.ops.hop_tpu_torch.gru_fused_layer_fwd(*args)
