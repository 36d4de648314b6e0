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

The forward kernel's two phases cannot run without a card;
`two_phase_gru_fused_layer` repeats them in torch: the projection of all
T * B rows once, each operand split into TF32 hi + lo (hi + lo = x to 2^-21
relative) and summed from three products, then the recurrence from the
projected gates. At these sizes (sums of at most 21 terms of O(0.1)) that
stays inside the same f32 round-off: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.ops.gru import GRU as JaxGRU
from hop_tpu.ops.pallas_gru_fused import gru_fused_layer as jax_gru_fused_layer

from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_seq as K6
from hop_tpu_torch.ops.gru import GRU
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

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


# H = 10 and 44 are ragged against the kernels' tiles as 350 is; I = 8 is the
# discriminator's first layer (one k-step of the projection)
# the last two: a layer wide enough for the cluster's forward recurrence
# (hidden units in eight slices of 26, the last one short; one sample, and a
# ragged batch)
TWO_PHASE_SHAPES = [(6, 3, 8, 10), (5, 4, 8, 44), (7, 2, 21, 10), (4, 1, 9, 203),
                    (3, 5, 12, 203)]


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", TWO_PHASE_SHAPES)
def test_two_phase_form_matches_plain_version(D, T, B, I, H):
    args = [torch.from_numpy(a) for a in _layer_inputs(T, B, I, H, D, seed=D + T + H)]
    assert args[5].abs().max() > 0          # a non-zero h0
    got = K2.two_phase_gru_fused_layer(*args, with_residuals=True)
    want = K2.plain_gru_fused_layer(*args, with_residuals=True)
    for name, a, b in zip(("out", "r", "z", "n", "hnb"), got, want):
        assert a.shape == (D, T, B, H)
        torch.testing.assert_close(a, b, rtol=0, atol=TOL, msg=name)
    torch.testing.assert_close(K2.two_phase_gru_fused_layer(*args), got[0])


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", TWO_PHASE_SHAPES)
def test_two_phase_form_matches_pallas_kernel(D, T, B, I, H):
    args = _layer_inputs(T, B, I, H, D, seed=D + T + H)
    want = jax_gru_fused_layer(*map(jnp.asarray, args), True)
    got = K2.two_phase_gru_fused_layer(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", TWO_PHASE_SHAPES)
def test_two_phase_form_matches_torch_nn_gru(D, T, B, I, H):
    """torch.nn.GRU holds a direction's gates stacked, (3H, I) and (3H, H),
    applied as x W^T; the layer's layout is (D, 3, I, H), applied as x W."""
    args = [torch.from_numpy(a) for a in _layer_inputs(T, B, I, H, D, seed=D + T + H)]
    x, wih, bih, whh, bhh, h0 = args
    ref = torch.nn.GRU(I, H, num_layers=1, bidirectional=D == 2)
    sd = {}
    for d, suffix in enumerate(["", "_reverse"][:D]):
        sd[f"weight_ih_l0{suffix}"] = wih[d].transpose(1, 2).reshape(3 * H, I)
        sd[f"weight_hh_l0{suffix}"] = whh[d].transpose(1, 2).reshape(3 * H, H)
        sd[f"bias_ih_l0{suffix}"] = bih[d].reshape(3 * H)
        sd[f"bias_hh_l0{suffix}"] = bhh[d].reshape(3 * H)
    ref.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        want = ref(x, h0.expand(D, B, H).contiguous())[0]        # (T, B, D * H)
    got = K2.two_phase_gru_fused_layer(*args)
    torch.testing.assert_close(got.permute(1, 2, 0, 3).reshape(T, B, D * H), want,
                               rtol=0, atol=TOL)


def test_tf32_split_keeps_f32_accuracy():
    """hi carries 10 mantissa bits, lo the next 10 of what is left: the pair
    is x to 2^-21 relative, and neither has a bit a TF32 operand drops."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 37.0
    hi, lo = K2._split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert not torch.equal(hi, x)


@pytest.mark.parametrize("H,variant", [
    (1, "block"),
    (37, "block"),
    (64, "block"),       # the discriminator: the widest one-block layer
    (65, "cluster"),
    (350, "cluster"),    # the head
    (352, "cluster"),    # the widest
    (353, None),         # refused, K6 too
])
def test_one_rule_for_both_directions_and_k6(H, variant):
    """The forward and the backward recurrence take one rule of H alone, and
    K6's wrapper takes what they take: up to MAX_H, refused above it on every
    device."""
    x = torch.zeros(1, 2, 3 * H)
    args = (x, torch.zeros(3 * H, H), torch.zeros(3 * H), torch.zeros(1, H))
    if variant is None:
        with pytest.raises(ValueError):
            K2.recurrence_variant(H)
        with pytest.raises(ValueError, match=f"H <= {K2.MAX_H}"):
            K6.gru_seq_layer(*args)
        return
    assert K2.recurrence_variant(H) == variant
    narrow = variant == "block"
    assert (H <= K2.NARROW_H) is narrow
    # the one-block backward holds a direction's whole W_hh (3, H, H) in
    # shared memory, a cluster block an eighth; the one-block forward holds
    # it in registers, its shared memory the same at every H
    assert (K2.recurrence_smem_bytes(H, True) >= 3 * H * H * 4) is narrow
    assert (K2.recurrence_smem_bytes(H) == K2.recurrence_smem_bytes(1)) is narrow
    assert K6.gru_seq_layer(*args).shape == (1, 2, H)


@pytest.mark.parametrize("B,D,rows", [
    (1, 1, 8), (8, 2, 8),            # one row tile: one window of a clip
    (9, 1, 24), (256, 1, 24),        # one direction (K6): 11 clusters at bs 256
    (9, 2, 40), (256, 2, 40),        # two: 14 clusters at bs 256, one wave
])
def test_forward_cluster_rows_are_pinned(B, D, rows):
    assert K2.forward_cluster_rows(B, D) == rows


@pytest.mark.parametrize("H,forward,backward", [
    (10, "block", "block"),
    (64, "block", "block"),        # the discriminator: no cluster either way
    (65, "cluster", "cluster"),    # the one-block instances end at 64
    (100, "cluster", "cluster"),
    (138, "cluster", "cluster"),
    (139, "cluster", "cluster"),
    (203, "cluster", "cluster"),
    (350, "cluster", "cluster"),   # the head
    (352, "cluster", "cluster"),   # the widest: 8 blocks of 44 units
])
def test_recurrence_variant_is_pinned(H, forward, backward):
    """Which recurrence kernel runs is a function of H alone, the same for
    the forward and the backward, and what it keeps in shared memory fits a
    block's 227 KB."""
    assert K2.recurrence_variant(H) == forward == backward
    for bwd in (False, True):
        assert 0 < K2.recurrence_smem_bytes(H, bwd) <= K2.SMEM_BLOCK_MAX


@pytest.mark.parametrize("H", [0, 353, 1024])
def test_recurrence_variant_refuses_other_widths(H):
    with pytest.raises(ValueError):
        K2.recurrence_variant(H)


@pytest.mark.parametrize("H", [37, 100, 203, 350, 352])
def test_cluster_slices_cover_the_units_once(H):
    """Eight slices of ceil(H / 8) units, the last short (or empty), and each
    block walks its peers from its own rank upwards."""
    slices = K2._unit_slices(H, K2.CLUSTER_BLOCKS)
    assert len(slices) == K2.CLUSTER_BLOCKS
    units = [u for sl in slices for u in range(sl.start, sl.stop)]
    assert units == list(range(H))
    assert max(sl.stop - sl.start for sl in slices) <= K2.CLUSTER_MAX_UNITS
    for c, (own, peers) in enumerate(K2._own_and_peers(H)):
        assert own == slices[c] and peers[0] == own
        assert sorted(p.start for p in peers) == sorted(
            sl.start for sl in slices if sl.stop > sl.start)


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
