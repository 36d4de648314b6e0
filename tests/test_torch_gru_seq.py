"""Kernel K6's module in the port (hop_tpu_torch.ops.gru_seq) against the
JAX package's batch-tiled Pallas GRU kernel.

`pallas_gru_layer` and `gru_forward_pallas` run with interpret=True, as
tests/test_pallas_gru.py runs them; the port takes its plain version on the
CPU. Same numpy inputs from a seed on both sides; f32 throughout, so the
tolerance is round-off carried through T recurrent steps, 1e-5.
`resident_gru_seq_layer` repeats the card's kernel's arithmetic (each
product as three TF32 hi/lo terms, hi + lo each operand to 2^-21; over the
whole of K in one block at H <= 64, over the cluster's slices above): held
to the plain version and to the Pallas kernel at the same 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.ops.gru import GRU as JaxGRU
from hop_tpu.ops.pallas_gru import gru_forward_pallas, pallas_gru_layer

from hop_tpu_torch.ops import gru_seq as K6
from hop_tpu_torch.ops.gru import GRU

TOL = 1e-5


def _layer_inputs(B, T, H, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, T, 3 * H)).astype(np.float32),
            (r.normal(size=(3 * H, H)) * 0.2).astype(np.float32),
            (r.normal(size=(3 * H,)) * 0.1).astype(np.float32),
            r.normal(size=(B, H)).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(7, 6, 8), (1, 34, 16)])   # ragged tile; bs 1
def test_layer_matches_pallas_kernel(B, T, H, reverse):
    args = _layer_inputs(B, T, H, seed=B + T)
    want = pallas_gru_layer(*map(jnp.asarray, args), reverse=reverse,
                            batch_tile=4, interpret=True)
    got = K6.gru_seq_layer(*map(torch.from_numpy, args), reverse=reverse)
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


# (B, T, H): one block (one sample; a ragged batch at the widest one-block
# layer), a cluster (one sample; a ragged batch, slices of 26 units)
RESIDENT_SHAPES = [(1, 6, 37), (7, 5, 64), (1, 4, 100), (9, 3, 203)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", RESIDENT_SHAPES)
def test_resident_layer_matches_plain_and_pallas(B, T, H, reverse):
    args = _layer_inputs(B, T, H, seed=B * T + H)
    targs = [torch.from_numpy(a) for a in args]
    got = K6.resident_gru_seq_layer(*targs, reverse=reverse)
    assert got.shape == (B, T, H) and got.dtype == torch.float32
    want = K6.plain_gru_seq_layer(*targs, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    pallas = pallas_gru_layer(*map(jnp.asarray, args), reverse=reverse,
                              batch_tile=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_stack_forward_matches_pallas_and_gru(bidirectional):
    """`gru_forward_seq` on the port GRU's parameters against
    `gru_forward_pallas` on the same weights, and against the port GRU's own
    output (kernel K2's route)."""
    B, T, F, H, layers = 5, 9, 12, 16, 2
    x = np.random.default_rng(0).normal(size=(B, T, F)).astype(np.float32)
    jgru = JaxGRU(hidden_size=H, num_layers=layers, bidirectional=bidirectional)
    params = jax.tree_util.tree_map(
        np.asarray, jgru.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = gru_forward_pallas(jnp.asarray(x), params, H, layers, bidirectional,
                              interpret=True)
    gru = GRU(F, H, num_layers=layers, bidirectional=bidirectional)
    gru.load_state_dict({n.replace("w_", "weight_", 1).replace("b_", "bias_", 1):
                         torch.from_numpy(a) for n, a in params.items()}, strict=True)
    tx = torch.from_numpy(x)
    got = K6.gru_forward_seq(tx, dict(gru.named_parameters()), H, layers,
                             bidirectional)
    assert not got.requires_grad                      # forward-only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    with torch.inference_mode():
        same, _ = gru(tx)
    np.testing.assert_allclose(got.numpy(), same.numpy(), rtol=0, atol=TOL)
    # the state_dict serves as well as the named parameters
    again = K6.gru_forward_seq(tx, gru.state_dict(), H, layers, bidirectional)
    assert torch.equal(again, got)


def test_wrapper_takes_plain_version_only_on_cpu():
    args = [torch.from_numpy(a).to("meta") for a in _layer_inputs(2, 3, 8, seed=0)]
    before = K6.launches
    with pytest.raises(ValueError, match="no kernel"):
        K6.gru_seq_layer(*args)
    assert K6.launches == before
