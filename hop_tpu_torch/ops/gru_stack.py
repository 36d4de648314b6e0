"""Time-grid GRU recurrence: kernel K3, forward (with residuals or lean) and
backward.

Replaces `gru_stack` of hop_tpu/ops/pallas_gru_stack.py (`_fwd_kernel`
:46-71 and `_fwd_kernel_lean` :73-97 called at :129-161, `_bwd_kernel`
:168-223 called at :225-263, custom VJP :270-316) with the CUDA kernels in
csrc/gru_stack.cu. The input projection x · W_ih + b_ih stays a plain matrix
product outside (one `torch.matmul` per layer, `ops/gru.py`); these kernels
run the recurrence from its three per-gate streams.

On the card a block (a narrow layer) or a cluster of eight blocks (the
head's H = 350: `gru_fused.recurrence_variant`) owns a batch tile and a
direction and loops over T with W resident on the chip; direction 1 is a
reversed time index, not a flipped copy. The streams are taken by their strides (unit stride on H), so the
three of them may be views of one (T, B, D, 3, H) product, and the backward
writes dxr, dxz, dxn into one such buffer and returns views of it. Streams
and their gradients may be bf16 (`GRU(bf16_streams=True)`); all arithmetic,
the h path and every other gradient are f32. The weight and bias gradients
are sums over T · B rows in a fixed order (no atomics): they repeat bit for
bit. See the .cu file for what bounds the kernels.

`plain_gru_stack` and `plain_gru_stack_bwd` are the same functions in torch;
`resident_gru_stack` and `resident_gru_stack_bwd` repeat the kernels'
arithmetic (the cluster's slices, 3xTF32 chains) for the CPU tests.
The wrappers take them only for a tensor on the CPU; for a CUDA tensor they
launch the kernels or raise.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops import gru_fused
from hop_tpu_torch.ops.gru_fused import hprev_of

#: launches of the forward kernel with residuals since the last reset
launches = 0
#: launches of the lean forward kernel (h only)
lean_launches = 0
#: launches of the backward kernels (one per backward call)
bwd_launches = 0

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def plain_gru_stack(xr, xz, xn, w, b, h0, with_residuals: bool = False):
    """Same contract as `gru_stack_fwd`, as per-step matmuls in torch."""
    D, T = xr.shape[:2]
    xr, xz, xn = (t.to(h0.dtype) for t in (xr, xz, xn))
    outs, res = [], []
    for d in range(D):
        h = h0
        ys, gates = [None] * T, [None] * T
        for t in (range(T) if d == 0 else reversed(range(T))):
            hp = torch.einsum("bk,gkh->gbh", h, w[d]) + b[d]
            r = torch.sigmoid(xr[d, t] + hp[0])
            z = torch.sigmoid(xz[d, t] + hp[1])
            n = torch.tanh(xn[d, t] + r * hp[2])
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


def plain_gru_stack_bwd(g, r, z, n, hnb, hprev, w, dx_dtype=torch.float32,
                        carry=gru_fused.plain_carry_product):
    """Same contract as `gru_stack_bwd`, in torch. `carry` takes a step's
    d_hid (B, 3, H) through w[d] to the dh carry (B, H)."""
    D, T, B, H = g.shape
    dx = g.new_zeros((T, B, D, 3, H))
    d_hid = g.new_zeros((T, B, D, 3, H))
    dh0 = g.new_zeros((D, B, H))
    for d in range(D):
        dh = g.new_zeros((B, H))
        for t in (reversed(range(T)) if d == 0 else range(T)):
            gt = g[d, t] + dh
            dn = gt * (1.0 - z[d, t]) * (1.0 - n[d, t] * n[d, t])
            dz = gt * (hprev[d, t] - n[d, t]) * z[d, t] * (1.0 - z[d, t])
            dr = dn * hnb[d, t] * r[d, t] * (1.0 - r[d, t])
            dx[t, :, d] = torch.stack([dr, dz, dn], dim=1)
            d_hid[t, :, d] = torch.stack([dr, dz, dn * r[d, t]], dim=1)
            dh = gt * z[d, t] + carry(d_hid[t, :, d], w[d])
        dh0[d] = dh
    dw = torch.einsum("dtbk,tbdgj->dgkj", hprev, d_hid)
    db = d_hid.sum(dim=(0, 1))[:, :, None]
    return (*_stream_views(dx.to(dx_dtype)), dw, db, dh0)


def resident_gru_stack(xr, xz, xn, w, b, h0, with_residuals: bool = False):
    """`plain_gru_stack`'s contract in the forward kernel's arithmetic at
    this H (`gru_fused.resident_hidden_product`), for tests."""
    return gru_fused.resident_gru_recurrence(xr, xz, xn, w, b, h0, with_residuals)


def resident_gru_stack_bwd(g, r, z, n, hnb, hprev, w, dx_dtype=torch.float32):
    """`plain_gru_stack_bwd`'s contract with the carry's product as the
    backward recurrence kernel at this H sums it
    (`gru_fused.resident_carry_product`), for tests."""
    return plain_gru_stack_bwd(g, r, z, n, hnb, hprev, w, dx_dtype,
                               carry=gru_fused.resident_carry_product)


def _stream_views(dx: torch.Tensor):
    """dxr, dxz, dxn, each (D, T, B, H), as views of dx (T, B, D, 3, H)."""
    return tuple(t.permute(2, 0, 1, 3) for t in dx.unbind(dim=3))


def _check_f32(named, shape, device):
    for name, t in named:
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != device):
            raise ValueError(f"{name} must be float32 {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_dims(D, H):
    if D > 2 or H > gru_fused.MAX_H:
        raise ValueError(f"kernel takes D <= 2 and H <= {gru_fused.MAX_H}, got "
                         f"D={D}, H={H}")


def gru_stack_fwd(xr: torch.Tensor, xz: torch.Tensor, xn: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  with_residuals: bool = False):
    """The recurrence of one (bi)directional layer from its gate streams.

    xr, xz, xn: (D, T, B, H) per-gate input projections (+ b_ih), f32 or
      bf16, stream 0 the forward and stream 1 the reverse direction; any
      strides of D, T and B that the three share, unit stride on H.
    w: (D, 3, H, H) recurrent weights (gate g maps h -> h @ w[d, g]).
    b: (D, 3, 1, H) recurrent biases. h0: (B, H) shared initial state.
    Returns h_seq (D, T, B, H) f32 in natural time order for both
    directions, and with `with_residuals` also r, z, n and
    hnb = h W[n] + b[n], each (D, T, B, H) f32.
    """
    if xr.device.type == "cpu":
        return plain_gru_stack(xr, xz, xn, w, b, h0, with_residuals)
    if xr.device.type != "cuda":
        raise ValueError(f"gru_stack: no kernel for device {xr.device}")
    global launches, lean_launches
    D, T, B, H = xr.shape
    _check_dims(D, H)
    if xr.dtype not in _STREAM_DTYPES:
        raise ValueError(f"gate streams must be float32 or bfloat16, got {xr.dtype}")
    for name, t in (("xr", xr), ("xz", xz), ("xn", xn)):
        if (tuple(t.shape) != (D, T, B, H) or t.dtype != xr.dtype
                or t.device != xr.device):
            raise ValueError(f"{name} must be {xr.dtype} {(D, T, B, H)} on "
                             f"{xr.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for (name, t), shape in zip((("w", w), ("b", b), ("h0", h0)),
                                ((D, 3, H, H), (D, 3, 1, H), (B, H))):
        _check_f32([(name, t)], shape, xr.device)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xr.stride(3) != 1 or not (xr.stride() == xz.stride() == xn.stride()):
        # streams cut some other way: one packed copy each
        xr, xz, xn = (t.contiguous() for t in (xr, xz, xn))
    sd, st, sb, _ = xr.stride()
    outs = [torch.empty((D, T, B, H), dtype=torch.float32, device=xr.device)
            for _ in range(5 if with_residuals else 1)]
    res_ptrs = [o.data_ptr() for o in outs[1:]] or [None] * 4
    lib = _build.load()
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = lib.hop_gru_stack_fwd(
        xr.data_ptr(), xz.data_ptr(), xn.data_ptr(), sd, st, sb,
        int(xr.dtype == torch.bfloat16), w.data_ptr(), b.data_ptr(),
        h0.data_ptr(), outs[0].data_ptr(), *res_ptrs, T, B, H, D, stream)
    _build.check(err, "hop_gru_stack_fwd")
    if with_residuals:
        launches += 1
        return tuple(outs)
    lean_launches += 1
    return outs[0]


def gru_stack_bwd(g, r, z, n, hnb, hprev, w, dx_dtype=torch.float32):
    """Gradients of the recurrence from its residuals (`_gru_stack_bwd`,
    pallas_gru_stack.py:298-313): g, r, z, n, hnb, hprev (D, T, B, H) f32
    with hprev the state each step started from; w as in the forward.
    Returns (dxr, dxz, dxn, dw, db, dh0): the stream gradients (D, T, B, H)
    in `dx_dtype`, views of one (T, B, D, 3, H) buffer; dw (D, 3, H, H),
    db (D, 3, 1, H) and dh0 (D, B, H), one slice per direction, f32."""
    if g.device.type == "cpu":
        return plain_gru_stack_bwd(g, r, z, n, hnb, hprev, w, dx_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"gru_stack_bwd: no kernel for device {g.device}")
    global bwd_launches
    D, T, B, H = g.shape
    _check_dims(D, H)
    if dx_dtype not in _STREAM_DTYPES:
        raise ValueError(f"dx_dtype must be float32 or bfloat16, got {dx_dtype}")
    _check_f32((("g", g), ("r", r), ("z", z), ("n", n), ("hnb", hnb),
                ("hprev", hprev)), (D, T, B, H), g.device)
    _check_f32([("w", w)], (D, 3, H, H), g.device)
    g, r, z, n, hnb, hprev, w = (t.contiguous() for t in (g, r, z, n, hnb, hprev, w))
    f32 = dict(dtype=torch.float32, device=g.device)
    dx = torch.empty((T, B, D, 3, H), dtype=dx_dtype, device=g.device)
    d_hid = torch.empty((T, B, D, 3, H), **f32)
    dw = torch.empty((D, 3, H, H), **f32)
    db = torch.empty((D, 3, 1, H), **f32)
    dh0 = torch.empty((D, B, H), **f32)
    lib = _build.load()
    n_work = lib.hop_gru_stack_bwd_workspace(T, B, H, D)
    work = torch.empty((n_work,), **f32) if n_work else None
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.hop_gru_stack_bwd(
        g.data_ptr(), r.data_ptr(), z.data_ptr(), n.data_ptr(), hnb.data_ptr(),
        hprev.data_ptr(), w.data_ptr(), dx.data_ptr(),
        int(dx_dtype == torch.bfloat16), d_hid.data_ptr(),
        work.data_ptr() if n_work else None, dw.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), T, B, H, D, stream)
    _build.check(err, "hop_gru_stack_bwd")
    bwd_launches += 1
    return (*_stream_views(dx), dw, db, dh0)


class _GRUStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xr, xz, xn, w, b, h0):
        h_seq, r, z, n, hnb = gru_stack_fwd(xr, xz, xn, w, b, h0,
                                            with_residuals=True)
        ctx.save_for_backward(r, z, n, hnb, h_seq, w, h0)
        ctx.dx_dtype = xr.dtype
        return h_seq

    @staticmethod
    def backward(ctx, g):
        r, z, n, hnb, h_seq, w, h0 = ctx.saved_tensors
        dxr, dxz, dxn, dw, db, dh0 = gru_stack_bwd(
            g.contiguous(), r, z, n, hnb, hprev_of(h_seq, h0), w, ctx.dx_dtype)
        return dxr, dxz, dxn, dw, db, dh0.sum(0)


@torch.library.custom_op("hop_tpu_torch::gru_stack_fwd", mutates_args=(),
                         device_types="cpu")
def gru_stack_op(xr: torch.Tensor, xz: torch.Tensor, xn: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The lean forward (h only) as a registered operator, so that
    `torch.export` keeps it as one node: on the CPU the plain version, on
    CUDA the kernel (`gru_stack_fwd`, which reads the streams by their
    strides: views of one projection cross the operator as views), and for
    fake tensors the shape alone. No other device has an implementation."""
    return plain_gru_stack(xr, xz, xn, w, b, h0)


@gru_stack_op.register_kernel("cuda")
def _(xr, xz, xn, w, b, h0):
    return gru_stack_fwd(xr, xz, xn, w, b, h0)


@gru_stack_op.register_fake
def _(xr, xz, xn, w, b, h0):
    return h0.new_empty(xr.shape)


def gru_stack(xr: torch.Tensor, xz: torch.Tensor, xn: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """`gru_stack_fwd`'s contract, differentiable in every operand (the
    stream gradients in the streams' dtype). Without a gradient to track it
    is the lean forward (no residuals), the registered operator
    `torch.ops.hop_tpu_torch.gru_stack_fwd`."""
    args = (xr, xz, xn, w, b, h0)
    _build.check_device(xr, "gru_stack")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GRUStack.apply(*args)
    return torch.ops.hop_tpu_torch.gru_stack_fwd(*args)
