"""Kernel K2's module in the port (hop_tpu_torch.ops.gru_fused) and the
port's GRU stack, on both of its routes, against the JAX package.

The JAX kernel `gru_fused_layer` runs with interpret=True and the JAX GRU
module in HOP_TPU_PALLAS_GRU=interpret-fused mode (for the port's "fused"
route) or =interpret (the time-grid kernel, for the port's "stack" route),
as tests/test_pallas_gru_fused.py and tests/test_pallas_gru_stack.py run
them. The port takes its plain versions on the CPU. Both are f32: the
tolerance covers f32 round-off carried through T recurrent steps, 1e-5;
gradients 1e-4 of each tensor's largest element; bf16 streams 2e-2 (bf16
quantisation of pre-activations of O(1), as tests/test_pallas_gru_stack.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.ops.gru import GRU as JaxGRU
from hop_tpu.ops.pallas_gru_fused import gru_fused_layer as jax_gru_fused_layer

from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops.gru import GRU

TOL = 1e-5


def _layer_inputs(T, B, I, H, D, seed):
    r = np.random.default_rng(seed)

    def arr(*shape):
        return (r.standard_normal(shape) * 0.3).astype(np.float32)
    return (arr(T, B, I), arr(D, 3, I, H), arr(D, 3, 1, H), arr(D, 3, H, H),
            arr(D, 3, 1, H), arr(B, H))


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", [(7, 4, 12, 16), (34, 3, 20, 24)])
def test_plain_layer_matches_pallas_kernel(D, T, B, I, H):
    args = _layer_inputs(T, B, I, H, D, seed=D * 10 + T)
    want = jax_gru_fused_layer(*map(jnp.asarray, args), True)
    got = K2.gru_fused_layer(*map(torch.from_numpy, args))
    assert got.shape == (D, T, B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_wrapper_takes_plain_version_only_on_cpu():
    args = [torch.from_numpy(a).to("meta")
            for a in _layer_inputs(3, 2, 4, 8, 2, seed=0)]
    before = K2.launches
    with pytest.raises(ValueError, match="no kernel"):
        K2.gru_fused_layer(*args)
    assert K2.launches == before


# the port's route and the JAX mode that runs the same kernel
ROUTES = [("fused", "interpret-fused"), ("stack", "interpret")]


@pytest.mark.parametrize("kernel,jax_mode", ROUTES)
def test_two_layer_gru_matches_jax(monkeypatch, kernel, jax_mode):
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", jax_mode)
    B, T, F, H = 5, 9, 12, 16
    x = np.random.default_rng(3).standard_normal((B, T, F)).astype(np.float32)
    jgru = JaxGRU(hidden_size=H, num_layers=2, bidirectional=True)
    params = jax.tree_util.tree_map(
        np.asarray, jgru.init(jax.random.PRNGKey(0), x)["params"])
    out_want, hid_want = jgru.apply({"params": params}, x)

    gru = GRU(F, H, num_layers=2, bidirectional=True, kernel=kernel)
    sd = {n.replace("w_", "weight_", 1).replace("b_", "bias_", 1):
          torch.from_numpy(a) for n, a in params.items()}
    gru.load_state_dict(sd, strict=True)
    assert set(sd) == set(torch.nn.GRU(F, H, 2, bidirectional=True).state_dict())
    with torch.inference_mode():
        out, hid = gru(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_want), rtol=0, atol=TOL)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_want), rtol=0, atol=TOL)


@pytest.mark.parametrize("kernel", ["fused", "stack"])
def test_gru_matches_torch_nn_gru(kernel):
    """Same parameter names and layout as torch.nn.GRU: load its weights and
    get its outputs and last hidden states."""
    torch.manual_seed(0)
    ref = torch.nn.GRU(10, 12, num_layers=3, batch_first=True,
                       bidirectional=True)
    gru = GRU(10, 12, num_layers=3, bidirectional=True, kernel=kernel)
    gru.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(4, 11, 10)
    with torch.inference_mode():
        out_want, hid_want = ref(x)
        out, hid = gru(x)
    torch.testing.assert_close(out, out_want, rtol=0, atol=TOL)
    torch.testing.assert_close(hid, hid_want, rtol=0, atol=TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_stack_route_equals_fused_route(bidirectional):
    """One state_dict serves both routes (same names and shapes, so
    `convert.py` maps the GRU once): outputs, last hidden states and every
    parameter's and the input's gradient agree."""
    torch.manual_seed(1)
    fused = GRU(10, 12, num_layers=2, bidirectional=bidirectional)
    stack = GRU(10, 12, num_layers=2, bidirectional=bidirectional, kernel="stack")
    assert [(k, v.shape) for k, v in stack.state_dict().items()] == \
        [(k, v.shape) for k, v in fused.state_dict().items()]
    stack.load_state_dict(fused.state_dict(), strict=True)
    x = torch.randn(4, 11, 10)
    g = torch.randn(4, 11, 12 * (1 + bidirectional))
    runs = []
    for gru in (fused, stack):
        xi = x.clone().requires_grad_()
        out, hid = gru(xi)
        grads = torch.autograd.grad(out, [xi, *gru.parameters()], g)
        runs.append((out, hid, grads))
    (out_f, hid_f, g_f), (out_s, hid_s, g_s) = runs
    torch.testing.assert_close(out_s, out_f, rtol=0, atol=TOL)
    torch.testing.assert_close(hid_s, hid_f, rtol=0, atol=TOL)
    for name, a, b in zip(["x", *dict(fused.named_parameters())], g_s, g_f):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item(),
                                   msg=name)


def test_stack_route_bf16_streams_track_f32():
    torch.manual_seed(2)
    f32 = GRU(10, 12, num_layers=2, bidirectional=True, kernel="stack")
    bf16 = GRU(10, 12, num_layers=2, bidirectional=True, kernel="stack",
               bf16_streams=True)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    x = torch.randn(4, 11, 10)
    out32, _ = f32(x)
    out16, _ = bf16(x)
    assert out16.dtype == torch.float32
    torch.testing.assert_close(out16, out32, rtol=0, atol=2e-2)
    assert not torch.equal(out16, out32)
    # trains through the bf16 streams: every parameter gets an f32 gradient
    out16.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in bf16.parameters())


def test_unknown_route_is_refused():
    with pytest.raises(ValueError, match="kernel must be one of"):
        GRU(4, 4, kernel="scan")
