"""Kernel K3's module in the port (hop_tpu_torch.ops.gru_stack) against the
JAX package's time-grid Pallas kernel.

`hop_tpu.ops.pallas_gru_stack.gru_stack` runs with interpret=True, as
tests/test_pallas_gru_stack.py runs it; the port takes its plain versions
on the CPU. The same numpy inputs from a seed go through both. Tolerances:
  * the f32 forward: 1e-5 absolute (round-off carried through T recurrent
    steps);
  * gradients: 1e-4 of each tensor's largest element (sums over T*B rows in
    another order);
  * bf16 streams against the f32 result: 2e-2, the bound
    tests/test_pallas_gru_stack.py uses for bf16 quantisation of
    pre-activations of O(1);
  * bf16 stream gradients, port against Pallas on the same bf16 streams:
    1e-2 of the largest element, since f32 values that differ in round-off
    may round to neighbouring bf16 values (2^-8 relative).
`resident_gru_stack` and `resident_gru_stack_bwd` repeat the card's
recurrence kernels' arithmetic in torch (each product as three TF32 hi/lo
terms in chains of their own, over the whole of K in the one-block kernels,
over the peers' slices in each block's order in the cluster's): held to the
plain versions and to the Pallas kernels at the same tolerances (hi + lo is
each operand to 2^-21, well inside 1e-5 through T steps), at the
discriminator's shape and at widths that are no multiple of 8 or of the
cluster's blocks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.ops.pallas_gru_stack import gru_stack as jax_gru_stack

from hop_tpu_torch.ops import gru_stack as K3
from hop_tpu_torch.ops.gru_fused import hprev_of
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

TOL = 1e-5
GRAD_REL = 1e-4
BF16_TOL = 2e-2
NAMES = ("dxr", "dxz", "dxn", "dw", "db", "dh0")


def _inputs(D, T, B, H, seed, dtype=np.float32):
    r = np.random.default_rng(seed)

    def arr(*shape):
        return (r.standard_normal(shape) * 0.3).astype(dtype)
    return ([arr(D, T, B, H) for _ in range(3)]
            + [arr(D, 3, H, H), arr(D, 3, 1, H), arr(B, H)]), arr(D, T, B, H)


def _assert_rel(got, want, rel, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    tol = rel * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("D", [1, 2])          # without / with the reverse stream
@pytest.mark.parametrize("T,B,H", [(7, 4, 16), (34, 5, 24)])   # B=5: a ragged tile
def test_forward_matches_pallas_kernel(D, T, B, H):
    args, _ = _inputs(D, T, B, H, seed=D * 10 + T)
    want = jax_gru_stack(*map(jnp.asarray, args), True)
    got = K3.gru_stack(*map(torch.from_numpy, args))
    assert got.shape == (D, T, B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # the residuals are the gates of the same recurrence
    out, r, z, n, hnb = K3.gru_stack_fwd(*map(torch.from_numpy, args),
                                         with_residuals=True)
    assert torch.equal(out, got)
    for t in (r, z, n, hnb):
        assert t.shape == (D, T, B, H)
    assert float(r.min()) > 0 and float(z.max()) < 1 and float(n.abs().max()) < 1


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,H", [(7, 4, 16), (28, 3, 24)])
def test_gradients_match_pallas_vjp(D, T, B, H):
    """Every operand's gradient, h0's too, through the autograd Function
    (plain forward with residuals, plain backward) against jax.vjp of the
    Pallas kernels."""
    args, g = _inputs(D, T, B, H, seed=D * 7 + T)
    _, vjp = jax.vjp(lambda *a: jax_gru_stack(*a, True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(K3.gru_stack(*targs), targs, torch.from_numpy(g))
    for name, a, b in zip(NAMES, got, want):
        _assert_rel(a, b, GRAD_REL, name)


def test_bwd_wrapper_matches_pallas_vjp_per_direction():
    """`gru_stack_bwd` itself: dx as views of one (T, B, D, 3, H) buffer, dh0
    one slice per direction."""
    D, T, B, H = 2, 9, 5, 16
    args, g = _inputs(D, T, B, H, seed=5)
    _, vjp = jax.vjp(lambda *a: jax_gru_stack(*a, True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    xr, xz, xn, w, b, h0 = map(torch.from_numpy, args)
    h_seq, r, z, n, hnb = K3.gru_stack_fwd(xr, xz, xn, w, b, h0, with_residuals=True)
    got = K3.gru_stack_bwd(torch.from_numpy(g), r, z, n, hnb, hprev_of(h_seq, h0), w)
    base = got[0]._base
    assert base is not None and base.shape == (T, B, D, 3, H)
    assert all(t._base is base for t in got[:3])
    assert got[5].shape == (D, B, H)
    for name, a, b in zip(NAMES[:5], got, want):
        _assert_rel(a, b, GRAD_REL, name)
    _assert_rel(got[5].sum(0), want[5], GRAD_REL, "dh0")


@pytest.mark.parametrize("D", [1, 2])
def test_plain_bwd_matches_autograd(D):
    """The plain backward against torch autograd of the plain forward, in
    float64 (exact up to f64 round-off)."""
    args, g = _inputs(D, 9, 5, 11, seed=D, dtype=np.float64)
    args = [torch.from_numpy(a).requires_grad_() for a in args]
    g = torch.from_numpy(g)
    want = torch.autograd.grad(K3.plain_gru_stack(*args), args, g)
    got = torch.autograd.grad(K3.gru_stack(*args), args, g)
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)


def test_bf16_streams_match_pallas_and_track_f32():
    """bf16 gate streams: the output stays f32 and tracks the f32 result
    within bf16 quantisation; the stream gradients come back in bf16; and
    the port agrees with the Pallas kernel fed the same bf16 streams."""
    D, T, B, H = 2, 7, 4, 16
    args, g = _inputs(D, T, B, H, seed=3)
    x16_j = [jnp.asarray(a).astype(jnp.bfloat16) for a in args[:3]]
    rest_j = [jnp.asarray(a) for a in args[3:]]
    want16, vjp = jax.vjp(lambda *x: jax_gru_stack(*x, *rest_j, True), *x16_j)
    want_g = vjp(jnp.asarray(g))

    x32 = [torch.from_numpy(a) for a in args[:3]]
    rest = [torch.from_numpy(a) for a in args[3:]]
    x16 = [t.to(torch.bfloat16).requires_grad_() for t in x32]
    y32 = K3.gru_stack(*x32, *rest)
    y16 = K3.gru_stack(*x16, *rest)
    assert y16.dtype == torch.float32
    np.testing.assert_allclose(y16.detach().numpy(), y32.numpy(), rtol=0, atol=BF16_TOL)
    np.testing.assert_allclose(y16.detach().numpy(), np.asarray(want16), rtol=0,
                               atol=TOL)
    got_g = torch.autograd.grad(y16, x16, torch.from_numpy(g))
    for name, a, b in zip(NAMES, got_g, want_g):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        _assert_rel(a, np.asarray(b, np.float32), 1e-2, name)
    # and they track the f32 gradients within bf16 quantisation
    x32g = [t.clone().requires_grad_() for t in x32]
    g32 = torch.autograd.grad(K3.gru_stack(*x32g, *rest), x32g, torch.from_numpy(g))
    for a16, a32 in zip(got_g, g32):
        np.testing.assert_allclose(a16.float().numpy(), a32.numpy(), rtol=0,
                                   atol=BF16_TOL)


# (T, B, H): both recurrences in one block (H <= 64), at the discriminator's
# T and H and at a width that is no multiple of 8; both in a cluster (H >
# 64), one sample and a ragged batch
RESIDENT_SHAPES = [(5, 1, 37), (28, 5, 64), (4, 3, 100), (3, 1, 203), (3, 9, 203)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,H", RESIDENT_SHAPES)
def test_resident_forward_matches_plain_and_pallas(D, T, B, H, dtype):
    args, _ = _inputs(D, T, B, H, seed=D + T + H)
    targs = [torch.from_numpy(a) for a in args]
    targs[:3] = [t.to(dtype) for t in targs[:3]]
    got = K3.resident_gru_stack(*targs, with_residuals=True)
    want = K3.plain_gru_stack(*targs, with_residuals=True)
    for name, a, b in zip(("h", "r", "z", "n", "hnb"), got, want):
        assert a.shape == (D, T, B, H) and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL, err_msg=name)
    assert torch.equal(K3.resident_gru_stack(*targs), got[0])
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                   else jnp.float32) for t in targs[:3]]
    pallas = jax_gru_stack(*jargs, *map(jnp.asarray, args[3:]), True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pallas), rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,H", RESIDENT_SHAPES)
def test_resident_backward_matches_plain_and_pallas(D, T, B, H, dtype):
    args, g = _inputs(D, T, B, H, seed=D * 3 + T + H)
    targs = [torch.from_numpy(a) for a in args]
    h_seq, r, z, n, hnb = K3.plain_gru_stack(*targs, with_residuals=True)
    bwd_args = (torch.from_numpy(g), r, z, n, hnb, hprev_of(h_seq, targs[5]), targs[3],
                dtype)
    got = K3.resident_gru_stack_bwd(*bwd_args)
    want = K3.plain_gru_stack_bwd(*bwd_args)
    _, vjp = jax.vjp(lambda *a: jax_gru_stack(*a, True), *map(jnp.asarray, args))
    pallas = vjp(jnp.asarray(g))
    for i, (name, a, b) in enumerate(zip(NAMES, got, want)):
        rel = 1e-2 if dtype == torch.bfloat16 and name.startswith("dx") else GRAD_REL
        assert a.dtype == b.dtype, name
        _assert_rel(a, b.float().numpy(), rel, name)
        # the Pallas kernel returns dh0 summed over the directions
        ref = np.asarray(pallas[i], np.float32)
        _assert_rel(a.sum(0) if name == "dh0" else a, ref, rel, name + " vs pallas")


def test_lean_forward_without_a_gradient():
    """No operand tracks a gradient, or grad mode is off: no graph."""
    args, _ = _inputs(2, 5, 3, 8, seed=0)
    targs = [torch.from_numpy(a) for a in args]
    assert not K3.gru_stack(*targs).requires_grad
    targs[3].requires_grad_()
    assert K3.gru_stack(*targs).requires_grad
    with torch.no_grad():
        assert not K3.gru_stack(*targs).requires_grad


def test_wrapper_takes_plain_version_only_on_cpu():
    args, g = _inputs(2, 3, 2, 8, seed=0)
    meta = [torch.from_numpy(a).to("meta") for a in args]
    before = (K3.launches, K3.lean_launches, K3.bwd_launches)
    with pytest.raises(ValueError, match="no kernel"):
        K3.gru_stack(*meta)
    with pytest.raises(ValueError, match="no kernel"):
        K3.gru_stack_bwd(*[torch.from_numpy(g).to("meta")] * 6, meta[3])
    assert (K3.launches, K3.lean_launches, K3.bwd_launches) == before
