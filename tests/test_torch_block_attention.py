"""Kernel K5 of the port (hop_tpu_torch.ops.block_attention), on the CPU
through its plain version, against hop_tpu.ops.pallas_block_attention's
`block_attention` in interpret mode (as tests/test_pallas_block_attention.py
runs it), and the backbone on that route against the JAX BertEncoder.

The port's plain version goes through the stacked masked (M, M) scores as
the kernels do, so these cases are an oracle of the block-diagonal mask too:
no sample sees another, however the batch is grouped, and a ragged last
group is masked. Tolerances as tests/test_torch_attention.py: forward 1e-5,
gradients 1e-4 of each gradient's largest element.

`register_block_attention` repeats the forward kernel's arithmetic in torch
(per 16-row strip only its samples' key tiles, the block-diagonal mask, the
exp2 softmax and the dropout on the strip's scores, P as hi + lo bf16 one
16-key tile at a time), held to EMULATION_TOL as K4's emulation is;
`register_block_attention_bwd` repeats the backward kernel's (groups
stacked as the kernel stacks them, then `strip_attention_bwd`), held to
EMULATION_BWD_REL as K4's is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.ops.pallas_block_attention import block_attention as jax_block_attention

from hop_tpu_torch.ops import attention as K4
from hop_tpu_torch.ops import block_attention as K5
from hop_tpu_torch.ops.dropout import attention_keep

from test_torch_attention import (EMULATION_BWD_REL, SHAPES, assert_emulation_close,
                                  assert_grads_close, bf16_exact, check_encoder_route,
                                  einsum_attention, inputs)
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

# (B, T, nb): groups of 1, 2, 3 and 8 samples, the last three with a ragged
# last group; T=17 puts a sample boundary inside a strip and T=40 a strip
# across three key tiles
REGISTER_CASES = [(3, 34, 1), (5, 34, 2), (11, 34, 3), (11, 34, 8), (9, 17, 8), (5, 40, 5)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_BLOCK_ATTN", "interpret")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_pallas(shape):
    q, k, v = inputs(shape, seed=shape[0], n=3)
    scale = shape[-1] ** -0.5
    want = jax_block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray([0], jnp.int32), scale, 0.0)
    got = K5.block_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradients_match_pallas_and_autograd(shape):
    q, k, v, g = inputs(shape, seed=10 + shape[0])
    scale = 0.3
    seed = jnp.asarray([0], jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_block_attention(q, k, v, seed, scale, 0.0),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    got = K5.block_attention_bwd(tq, tk, tv, tg, scale)
    assert_grads_close(got, vjp(jnp.asarray(g)))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    assert_grads_close(got, torch.autograd.grad(
        einsum_attention(*leaves, scale), leaves, tg))
    assert_grads_close(torch.autograd.grad(
        K5.block_attention(*leaves, scale), leaves, tg), got, rel=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,nb", REGISTER_CASES)
def test_register_forward_matches_plain_version(B, T, nb, rate):
    q, k, v = bf16_exact(inputs((B, T, 2, 16), seed=B + T, n=3))
    got = K5.register_block_attention(q, k, v, 0.25, rate, 13, nb=nb)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert_emulation_close(got, K5.plain_block_attention(q, k, v, 0.25, rate, 13, nb=nb), v)
    # K4's plain version: the function per sample and its mask
    assert_emulation_close(got, K4.plain_fused_attention(q, k, v, 0.25, rate, 13), v)


@pytest.mark.parametrize("B,T,nb", REGISTER_CASES)
def test_register_forward_matches_pallas(B, T, nb):
    q, k, v = bf16_exact(inputs((B, T, 2, 16), seed=50 + B + T, n=3))
    want = jax_block_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               jnp.asarray([0], jnp.int32), 0.25, 0.0)
    assert_emulation_close(K5.register_block_attention(q, k, v, 0.25, nb=nb), want, v)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,nb", REGISTER_CASES)
def test_register_backward_matches_plain_version(B, T, nb, rate):
    q, k, v, g = bf16_exact(inputs((B, T, 2, 16), seed=B + T))
    got = K5.register_block_attention_bwd(q, k, v, g, 0.25, rate, 13, nb=nb)
    assert all(t.dtype == torch.float32 and t.shape == q.shape for t in got)
    assert_grads_close(got, K5.plain_block_attention_bwd(q, k, v, g, 0.25, rate, 13, nb=nb),
                       EMULATION_BWD_REL)
    # K4's plain version: the function per sample and its mask
    assert_grads_close(got, K4.plain_fused_attention_bwd(q, k, v, g, 0.25, rate, 13),
                       EMULATION_BWD_REL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_register_backward_in_any_grouping(nb, rate):
    """B=11 in groups of 1, 2, 4 and 8 (the last three ragged): the same
    gradients, and K4's emulation's (one algorithm, a sample a group)."""
    q, k, v, g = bf16_exact(inputs((11, 34, 2, 16), seed=60))
    got = K5.register_block_attention_bwd(q, k, v, g, 0.25, rate, 17, nb=nb)
    assert_grads_close(got, K4.plain_fused_attention_bwd(q, k, v, g, 0.25, rate, 17),
                       EMULATION_BWD_REL)
    assert_grads_close(got, K4.tiled_fused_attention_bwd(q, k, v, g, 0.25, rate, 17),
                       EMULATION_BWD_REL)


@pytest.mark.parametrize("B,T,nb", REGISTER_CASES)
def test_register_backward_matches_pallas(B, T, nb):
    q, k, v, g = bf16_exact(inputs((B, T, 2, 16), seed=70 + B + T))
    seed = jnp.asarray([0], jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_block_attention(q, k, v, seed, 0.25, 0.0),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    assert_grads_close(K5.register_block_attention_bwd(q, k, v, g, 0.25, nb=nb),
                       vjp(jnp.asarray(g.numpy())), EMULATION_BWD_REL)


def test_strip_key_tiles():
    """At the backbone's T=34 a strip needs at most 5 key tiles (the forward
    kernel's template argument) in any grouping."""
    # rows 32-47 hold samples 0 and 1: keys 0-67, tiles 0-4
    assert K5.sample_span(32, 272, 34) == (0, 5) and K5.sample_span(16, 272, 34) == (0, 3)
    assert max(K5.key_tiles(34, nb) for nb in range(1, 9)) == 5


def test_gradcheck_float64():
    r = np.random.default_rng(0)
    q, k, v = (torch.tensor(r.standard_normal((3, 5, 2, 4)), requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: K5.block_attention(a, b, c, 0.4, 0.2, 3), (q, k, v))


def test_groups_and_ragged_batches():
    """`group_size` stacks 8 samples, fewer for a small batch; a ragged last
    group (B=11: 8 + 3, B=1) and any grouping give the per-sample result."""
    assert K5.group_size(256, 34) == 8 and K5.group_size(1, 34) == 1
    assert K5.group_size(250, 34) == 8 and K5.group_size(5, 100) == 2
    assert list(K5._spans(11, 8)) == [(0, 8, 8), (8, 11, 3)]
    assert list(K5._spans(16, 8)) == [(0, 16, 8)] and list(K5._spans(1, 1)) == [(0, 1, 1)]
    # a 16-row strip of 8 stacked 34-row samples needs at most 5 key tiles
    assert K5.key_tiles(34, 8) == 5 and K5.key_tiles(34, 1) == 3
    assert K5.key_tiles(64, 4) == 4 and K5.key_tiles(50, 4) > K5.MAX_TILES
    for B in (11, 1):
        q, k, v, g = map(torch.from_numpy, inputs((B, 34, 2, 8), seed=B))
        want = K4.plain_fused_attention(q, k, v, 0.3, 0.1, 9)
        want_g = K4.plain_fused_attention_bwd(q, k, v, g, 0.3, 0.1, 9)
        for nb in (None, 1, 2, 4, 8):
            got = K5.plain_block_attention(q, k, v, 0.3, 0.1, 9, nb=nb)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
            assert_grads_close(
                K5.plain_block_attention_bwd(q, k, v, g, 0.3, 0.1, 9, nb=nb), want_g)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_no_cross_sample_leakage(rate):
    """Perturbing one sample leaves every other sample's output and gradient
    bit-unchanged, though they share one stacked score matrix."""
    q, k, v, g = map(torch.from_numpy, inputs((4, 34, 2, 8), seed=7))
    args = (0.125, rate, 3)
    base = K5.block_attention_fwd(q, k, v, *args)
    base_g = K5.block_attention_bwd(q, k, v, g, *args)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[3] += 1.0
    k2[3] = k[3] * 100.0 + 5.0
    v2[3] = -v[3]
    pert = K5.block_attention_fwd(q2, k2, v2, *args)
    pert_g = K5.block_attention_bwd(q2, k2, v2, g, *args)
    assert torch.equal(base[:3], pert[:3])
    assert not torch.allclose(base[3], pert[3])
    for a, b in zip(base_g, pert_g):
        assert torch.equal(a[:3], b[:3])
        assert not torch.allclose(a[3], b[3])


def test_dropout_mask_is_k4s():
    """K4 and K5 draw one mask for one seed (the key coordinate is the key's
    index inside its sample, not its stacked column), the backward reuses
    it, and the keep rate and the seeds behave."""
    shape = (11, 34, 2, 8)
    q, k, v, g = map(torch.from_numpy, inputs(shape, seed=5))
    B, T, H, _ = shape
    scale, rate, seed = 0.3, 0.3, 21
    a = K5.block_attention(q, k, v, scale, rate, seed)
    torch.testing.assert_close(a, K4.fused_attention(q, k, v, scale, rate, seed),
                               rtol=0, atol=1e-5)
    assert torch.equal(a, K5.block_attention(q, k, v, scale, rate, seed))
    assert not torch.allclose(a, K5.block_attention(q, k, v, scale, rate, seed + 1))
    assert not torch.allclose(a, K5.block_attention(q, k, v, scale))
    keep = attention_keep(seed, rate, B, T, H, T, "cpu")
    n = keep.numel()
    assert abs((keep > 0).float().mean().item() - (1 - rate)) < 3 * (rate * (1 - rate) / n) ** 0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(einsum_attention(*leaves, scale, keep), leaves, g)
    assert_grads_close(torch.autograd.grad(
        K5.block_attention(*leaves, scale, rate, seed), leaves, g), want)


def test_bert_encoder_on_the_block_route(monkeypatch):
    check_encoder_route("block", monkeypatch, "HOP_TPU_PALLAS_BLOCK_ATTN")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(4, 50, 2, 64)
    with pytest.raises(ValueError, match="key tiles"):
        K5._check("block_attention", q, q, q, None)
    q = torch.zeros(4, 34, 2, 64)
    with pytest.raises(ValueError, match="key tiles"):
        K5._check("block_attention", q, q, q, 9)
    assert K5._check("block_attention", q, q, q, None) == (4, 34, 2, 4)
