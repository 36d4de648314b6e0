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
* The backward kernels' arithmetic in torch (`sliced_gru_fused_layer_bwd`:
  3xTF32 products over ordered K slices; `tiled_reprogramming_attention_bwd`:
  bf16 operands, exp2 from the LSE, dS and P as hi + lo bf16, row runs added
  in order) against the plain backwards and the Pallas VJPs. K2: the TF32
  split leaves 2^-21 relative an operand and the slices change only the
  order of f32 sums: 1e-5 of each gradient's largest element. K1: both sides
  get bf16-rounded q, k, v and dO; the hi + lo pairs leave 2^-17: 1e-4
  relative. The slice and run counts are functions of the shape alone and
  are pinned.
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
    keep = drop.attention_keep(7, 0.1, B, L, H, S, "cpu") > 0
    assert abs(keep.float().mean().item() - 0.9) < 0.009
    assert torch.equal(keep, drop.attention_keep(7, 0.1, B, L, H, S, "cpu") > 0)
    other = drop.attention_keep(8, 0.1, B, L, H, S, "cpu") > 0
    assert (other != keep).float().mean().item() > 0.1
    # a mask bit depends on the global coordinates alone: a sub-batch draws
    # the same bits for the rows it shares
    bits = drop.attention_bits(7, B, L, H, S, "cpu")
    assert torch.equal(drop.attention_bits(7, 2, L, H, S, "cpu"), bits[:2])
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


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# (T, B, I, H, D): small; K = T * B of several thousand in many slices; dx's
# K cut into slices that cross its (direction, gate) segments; both sides
# above one 64-wide tile
K2_SLICED = [(7, 4, 12, 16, 1), (7, 4, 12, 16, 2), (40, 128, 12, 16, 2),
             (7, 4, 12, 100, 2), (9, 70, 130, 131, 2),
             # the dh carry through a cluster's eight slices of the units at a
             # ragged width, one sample and one direction; and in one block
             (5, 1, 12, 203, 2), (4, 9, 10, 203, 1), (5, 1, 9, 37, 2)]


def _k2_bwd_args(T, B, I, H, D, seed):
    args, g = _k2_inputs(T, B, I, H, D, seed)
    x, wih, bih, whh, bhh, h0 = map(torch.from_numpy, args)
    h_seq, r, z, n, hnb = K2.plain_gru_fused_layer(x, wih, bih, whh, bhh, h0,
                                                   with_residuals=True)
    return (torch.from_numpy(g), x, r, z, n, hnb, K2.hprev_of(h_seq, h0), wih, whh)


@pytest.mark.parametrize("T,B,I,H,D", K2_SLICED)
def test_k2_sliced_bwd_matches_plain(T, B, I, H, D):
    bwd_args = _k2_bwd_args(T, B, I, H, D, seed=T + H)
    want = K2.plain_gru_fused_layer_bwd(*bwd_args)
    got = K2.sliced_gru_fused_layer_bwd(*bwd_args)
    for name, a, b in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("B,H", [(1, 37), (5, 64), (3, 100), (1, 203), (7, 350)])
def test_resident_carry_product_matches_plain(B, H):
    """d_hid . W_hh^T as the backward recurrence kernel sums it (one block up
    to H = 64, the cluster's slices above) against the plain product."""
    r = np.random.default_rng(B + H)
    d_hid = torch.from_numpy(r.standard_normal((B, 3, H)).astype(np.float32))
    whh = torch.from_numpy((r.standard_normal((3, H, H)) * H ** -0.5).astype(np.float32))
    want = torch.einsum("bgk,gjk->bj", d_hid.double(), whh.double()).float()
    got = K2.resident_carry_product(d_hid, whh)
    assert got.shape == (B, H)
    assert _rel(got, want) <= 2e-6, _rel(got, want)
    assert _rel(K2.plain_carry_product(d_hid, whh), want) <= 2e-6


def test_k2_sliced_products_cut_k_as_planned():
    # the cases above reach: many slices of K = T * B; dx slices that cross
    # segments; and one chain where the tiles fill the card
    assert K2.gemm_plan(12, 16, 40 * 128, 1, 6) == (False, 20, 8)
    assert K2.gemm_plan(7 * 4, 12, 100, 6, 1) == (False, 3, 8)
    assert K2.gemm_plan(34 * 256, 992, 350, 6, 1) == (True, 1, 66)
    # a slice is never deeper than GEMM_MAX_SLICE: the accumulator chain
    for M, N, K, nseg, nz in [(992, 350, 8704, 1, 6), (350, 350, 8704, 1, 6),
                              (8704, 992, 350, 6, 1), (64, 64, 7168, 1, 6),
                              (4096, 4096, 100000, 1, 1)]:
        _, ksplit, per_slice = K2.gemm_plan(M, N, K, nseg, nz)
        assert per_slice * K2.GEMM_K_TILE <= K2.GEMM_MAX_SLICE
        assert (ksplit - 1) * per_slice < nseg * -(-K // K2.GEMM_K_TILE) <= ksplit * per_slice


def test_k2_sliced_bwd_matches_pallas_vjp():
    T, B, I, H, D = 28, 3, 8, 24, 2
    args, g = _k2_inputs(T, B, I, H, D, seed=5)
    _, vjp = jax.vjp(lambda *a: jax_gru_fused_layer(*a, True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    got = K2.sliced_gru_fused_layer_bwd(*_k2_bwd_args(T, B, I, H, D, seed=5))
    for name, a, b in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=name)


def test_k2_split_counts_depend_on_the_shape_alone():
    # the head's and the discriminator's products: (tile, slices, k tiles a slice)
    assert K2.gemm_plan(992, 350, 8704, 1, 6) == (True, 5, 55)
    assert K2.gemm_plan(700, 350, 8704, 1, 6) == (True, 7, 39)
    assert K2.gemm_plan(350, 350, 8704, 1, 6) == (True, 9, 31)
    assert K2.gemm_plan(7168, 128, 64, 6, 1) == (False, 1, 12)
    assert K2.gemm_plan(8, 64, 7168, 1, 6) == (False, 28, 8)
    assert K2.gemm_plan(64, 64, 7168, 1, 6) == (False, 28, 8)
    # the workspace is the largest product's partial tiles
    assert K2.bwd_workspace_floats(34, 256, 992, 350, 2) == 5 * 6 * 992 * 350
    assert K2.bwd_workspace_floats(28, 256, 8, 64, 2) == 28 * 6 * 64 * 64
    assert K2.bwd_workspace_floats(5, 11, 20, 40, 2) == 0


@pytest.mark.parametrize("n_runs", [None, 1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L,H,S", [(3, 34, 2, 65), (2, 50, 2, 70)])
def test_k1_tiled_bwd_matches_plain(B, L, H, S, rate, n_runs):
    # B * L = 102 and 100: two 64-row chunks, the last ragged; S one key past
    # a tile and six past
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16).float()
                  for a in _k1_inputs(B, L, H, 128, S, seed=B + S))
    args = (128 ** -0.5, rate, 77)
    out, lse = K1.plain_reprogramming_attention(q, k, v, *args, with_lse=True)
    want = K1.plain_reprogramming_attention_bwd(q, k, v, out, lse, g, *args)
    got = K1.tiled_reprogramming_attention_bwd(q, k, v, out, lse, g, *args,
                                               n_runs=n_runs)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


def test_k1_tiled_bwd_matches_pallas_vjp():
    B, L, H, E, S = 3, 34, 2, 128, 65
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16).float()
                  for a in _k1_inputs(B, L, H, E, S, seed=3))
    scale = E ** -0.5
    seed = jnp.asarray([0], jnp.int32)
    _, vjp = jax.vjp(
        lambda q, k, v: fused_reprogramming_attention(q, k, v, seed, scale, 0.0),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(g.numpy()))
    out, lse = K1.plain_reprogramming_attention(q, k, v, scale, with_lse=True)
    got = K1.tiled_reprogramming_attention_bwd(q, k, v, out, lse, g, scale, n_runs=2)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=name)


def test_k1_row_runs_depend_on_the_shape_alone():
    assert K1.bwd_row_runs(256, 34, 8, 1500) == 4     # 192 tiles x 4 = 768 of 792
    assert K1.bwd_row_runs(250, 34, 8, 1500) == 4
    assert K1.bwd_row_runs(1, 34, 8, 1500) == 1       # one chunk
    assert K1.bwd_row_runs(3, 34, 2, 65) == 2
    assert K1.bwd_row_runs(40, 70, 8, 100) == 15      # 44 chunks in runs of 3
    for B, L, H, S in [(256, 34, 8, 1500), (40, 70, 8, 100), (7, 9, 3, 10),
                       (1000, 34, 8, 64)]:
        runs = K1.bwd_row_runs(B, L, H, S)
        chunks = -(-B * L // K1.ROW_TILE)
        per_run = -(-chunks // runs)
        # every run holds a chunk, as the C entry demands
        assert 1 <= runs <= K1.MAX_ROW_RUNS and (runs - 1) * per_run < chunks
