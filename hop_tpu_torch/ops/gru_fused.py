"""Fused bidirectional GRU layer: kernel K2, forward and backward.

Replaces the TPU kernel `gru_fused_layer` of hop_tpu/ops/pallas_gru_fused.py
(`_make_fwd_kernel` :113-144 called at :147-195, `_make_bwd_kernel`
:202-310 called at :313-373, custom VJP `_fused_fwd`/`_fused_bwd`
:397-418) with the CUDA kernels in csrc/gru_fused.cu: one GRU layer, both
directions, the gate input projections x · W_ih fused into the recurrence
h · W_hh.

On the card (HOP head: T=34, B=256, I=992 in layer 0 and 700 after,
H=350; discriminator: T=28, H=64, I=8 then 128) the recurrence is serial
in T, so the forward holds a batch tile's h in shared memory and loops
over T inside one block per (tile, direction); the weights of a direction
(5.7 MB at I=992) stay in L2 and are re-read at every step. In training the
forward also writes the gates r, z, n and hnb = h W_hh[n] + b_hh[n]. The
backward runs the serial dh recurrence in one kernel (gate-gradient
streams out) and everything else (dx, dW_ih, dW_hh: ≈85 of the ≈98 GFLOP
of a head layer at I=992) as tiled GEMMs whose blocks each own an output
tile and a slice of K (slices summed in order by a second kernel where the
tiles are too few to fill the card); the bias gradients are ordered column
sums. No atomics, so the gradients repeat bit for bit (see the .cu file).

`plain_gru_fused_layer` is the JAX scan math (hop_tpu/ops/gru.py:157-183)
in torch on the same (D, 3, I, H) weight layout; `plain_gru_fused_layer_bwd`
is the backward in the kernels' split (gate grads by a reversed loop, then
products and sums). The wrappers take them only for a tensor on the CPU;
for a CUDA tensor they launch the kernels or raise.
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


def plain_gru_fused_layer_bwd(g, x, r, z, n, hnb, hprev, wih, whh):
    """Same contract as `gru_fused_layer_bwd`, in torch."""
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
            dh = gt * z[d, t] + torch.einsum("bgk,gjk->bj", d_hid[t, :, d], whh[d])
        dh0[d] = dh
    dx = torch.einsum("tbdgj,dgij->tbi", d_in, wih)
    dwih = torch.einsum("tbi,tbdgj->dgij", x, d_in)
    dwhh = torch.einsum("dtbk,tbdgj->dgkj", hprev, d_hid)
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
    if D > 2 or H > 1024:
        raise ValueError(f"kernel takes D <= 2 and H <= 1024, got D={D}, H={H}")
    return T, B, I, H, D


def gru_fused_layer_fwd(x: torch.Tensor, wih: torch.Tensor, bih: torch.Tensor,
                        whh: torch.Tensor, bhh: torch.Tensor, h0: torch.Tensor,
                        with_residuals: bool = False):
    """One (bi)directional GRU layer, projection and recurrence in one kernel.

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
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.hop_gru_fused_fwd(x.data_ptr(), wih.data_ptr(), bih.data_ptr(),
                                whh.data_ptr(), bhh.data_ptr(), h0.data_ptr(),
                                outs[0].data_ptr(), *res_ptrs,
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
    if D > 2 or H > 1024:
        raise ValueError(f"kernel takes D <= 2 and H <= 1024, got D={D}, H={H}")
    g, x, r, z, n, hnb, hprev = (t.contiguous() for t in (g, x, r, z, n, hnb, hprev))
    # the kernels read W_ih and W_hh transposed, coalesced along their rows
    wih_t = wih.transpose(2, 3).contiguous()
    whh_t = whh.transpose(2, 3).contiguous()
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
        hnb.data_ptr(), hprev.data_ptr(), wih_t.data_ptr(), whh_t.data_ptr(),
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


def gru_fused_layer(x: torch.Tensor, wih: torch.Tensor, bih: torch.Tensor,
                    whh: torch.Tensor, bhh: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """`gru_fused_layer_fwd`'s contract, differentiable in every operand.
    Without a gradient to track it is the lean forward (no residuals)."""
    args = (x, wih, bih, whh, bhh, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GRUFusedLayer.apply(*args)
    return gru_fused_layer_fwd(*args)
