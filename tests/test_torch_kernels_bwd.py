"""The backwards of kernels K1 and K2 in the port, and the dropout bits K1
draws, on the CPU.

* The port's plain backwards against `jax.vjp` of the JAX Pallas kernels
  in interpret mode (as tests/test_pallas_reprogramming.py and
  tests/test_pallas_gru_fused.py run them): K1 at rate 0 (the JAX kernel's
  mask comes from another generator), K2 for one and two directions. Both
  sides are f32; the tolerance is f32 round-off of sums over the key axis
  (K1) or carried through T recurrent steps (K2): 2e-4 on gradients of
  O(1-10), as tests/test_pallas_gru_fused.py uses.
* The plain backwards against torch autograd of the plain forwards: K1 at
  rate 0.1 with the same mask on both sides, K2 in float64 (exact up to
  f64 round-off).
* The dropout hash: keep rate, and masks that follow the seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.ops.pallas_gru_fused import gru_fused_layer as jax_gru_fused_layer
from hop_tpu.ops.pallas_reprogramming import fused_reprogramming_attention

from hop_tpu_torch.ops import dropout as drop
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import reprogramming_attention as K1

TOL = 2e-4


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")


def _k1_inputs(B, L, H, E, S, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32)
            for shape in ((B, L, H, E), (H, S, E), (H, S, E), (B, L, H, E))]


@pytest.mark.parametrize("B,L,H,E,S", [(4, 34, 4, 16, 70), (3, 34, 2, 128, 65)])
def test_k1_plain_bwd_matches_pallas_vjp(B, L, H, E, S):
    q, k, v, g = _k1_inputs(B, L, H, E, S, seed=B + S)
    scale = E ** -0.5
    seed = jnp.asarray([0], jnp.int32)
    want_out, vjp = jax.vjp(
        lambda q, k, v: fused_reprogramming_attention(q, k, v, seed, scale, 0.0),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = K1.reprogramming_attention_fwd(tq, tk, tv, scale, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    got = K1.reprogramming_attention_bwd(tq, tk, tv, out, lse,
                                         torch.from_numpy(g), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_plain_bwd_matches_autograd(rate):
    B, L, H, E, S = 3, 34, 2, 16, 50
    q, k, v, g = (torch.from_numpy(a) for a in _k1_inputs(B, L, H, E, S, seed=9))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    scale, seed = 0.3, 1234
    out = K1.plain_reprogramming_attention(q, k, v, scale, rate, seed)
    want = torch.autograd.grad(out, (q, k, v), g)
    # the autograd Function: plain forward with LSE, plain backward
    got = torch.autograd.grad(
        K1.reprogramming_attention(q, k, v, scale, rate, seed), (q, k, v), g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4, msg=name)
    if rate > 0:   # the mask is in the forward: another seed, another output
        other = K1.plain_reprogramming_attention(q, k, v, scale, rate, seed + 1)
        assert not torch.allclose(other, out)


def _k2_inputs(T, B, I, H, D, seed, dtype=np.float32):
    r = np.random.default_rng(seed)

    def arr(*shape):
        return (r.standard_normal(shape) * 0.3).astype(dtype)
    return [arr(T, B, I), arr(D, 3, I, H), arr(D, 3, 1, H), arr(D, 3, H, H),
            arr(D, 3, 1, H), arr(B, H)], arr(D, T, B, H)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", [(7, 4, 12, 16), (28, 3, 8, 24)])
def test_k2_plain_bwd_matches_pallas_vjp(D, T, B, I, H):
    args, g = _k2_inputs(T, B, I, H, D, seed=D * 10 + T)
    _, vjp = jax.vjp(lambda *a: jax_gru_fused_layer(*a, True),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))

    x, wih, bih, whh, bhh, h0 = map(torch.from_numpy, args)
    h_seq, r, z, n, hnb = K2.gru_fused_layer_fwd(x, wih, bih, whh, bhh, h0,
                                                 with_residuals=True)
    got = K2.gru_fused_layer_bwd(torch.from_numpy(g), x, r, z, n, hnb,
                                 K2.hprev_of(h_seq, h0), wih, whh)
    for name, a, b in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("D", [1, 2])
def test_k2_plain_bwd_matches_autograd(D):
    args, g = _k2_inputs(9, 5, 6, 11, D, seed=D, dtype=np.float64)
    args = [torch.from_numpy(a).requires_grad_() for a in args]
    g = torch.from_numpy(g)
    want = torch.autograd.grad(K2.plain_gru_fused_layer(*args), args, g)
    got = torch.autograd.grad(K2.gru_fused_layer(*args), args, g)
    for name, a, b in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)


def test_dropout_keep_rate_and_seeds():
    B, L, H, S = 16, 34, 8, 500        # 2.2e6 draws
    keep = drop.attention_keep(7, 0.1, B, L, H, S) > 0
    assert abs(keep.float().mean().item() - 0.9) < 0.009
    assert torch.equal(keep, drop.attention_keep(7, 0.1, B, L, H, S) > 0)
    other = drop.attention_keep(8, 0.1, B, L, H, S) > 0
    assert (other != keep).float().mean().item() > 0.1
    # a mask bit depends on the global coordinates alone: a sub-batch draws
    # the same bits for the rows it shares
    bits = drop.attention_bits(7, B, L, H, S)
    assert torch.equal(drop.attention_bits(7, 2, L, H, S), bits[:2])
    assert drop.threshold(0.1) == int(0.1 * 2 ** 32)
    with pytest.raises(ValueError):
        drop.threshold(1.0)


def test_fmix32_matches_uint32_arithmetic():
    x = np.random.default_rng(0).integers(0, 2 ** 32, size=10000, dtype=np.uint64)
    want = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        for shift, mult in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, None)):
            want = want ^ (want >> np.uint32(shift))
            if mult is not None:
                want = want * np.uint32(mult)
    got = drop.fmix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
