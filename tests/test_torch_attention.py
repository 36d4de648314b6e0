"""Kernel K4 of the port (hop_tpu_torch.ops.attention), on the CPU through
its plain version, against hop_tpu.ops.pallas_attention's `fused_attention`
in interpret mode (as tests/test_pallas_attention.py runs it), and the
backbone on that route against the JAX BertEncoder.

Both sides are f32. Forward 1e-5 (round-off of sums over T <= 34 keys);
gradients 1e-4 of each gradient's largest element. With dropout on, the two
packages draw different masks (hop_tpu seeds a generator per program, the
port hashes global coordinates), so those cases hold the port to itself:
keep rate, seeds, and a backward that reuses the forward's mask.

The forward kernel's own arithmetic (16-row query tiles, keys padded to
whole 16-key steps and masked, the softmax in the exp2 domain, the
probabilities fed to P V as hi + lo bf16) cannot run without a card;
`tiled_fused_attention` repeats it in torch. On bf16-exact operands what it
adds to f32 round-off is the hi + lo pair's error, at most 2^-18 of each
probability, so the output is off by at most ~4e-6 of the largest |v|:
EMULATION_TOL is 1e-5 of the largest |v|, against the plain version (with
the same mask) and against the Pallas kernel.

The backward kernel's arithmetic (K5's algorithm with a sample as a group:
16-row query tiles and 16-key tiles with clamped pad rows, the softmax
recomputed in the exp2 domain in both phases, P o keep and dS fed to their
products as hi + lo bf16, tile by tile) is `tiled_fused_attention_bwd`.
Each term then carries at most 2^-18 of its size from the hi + lo pair
besides f32 round-off; over T <= 64 terms the gradients agree with the
plain version to ~7e-6 of their largest element: EMULATION_BWD_REL is 2e-5
of each gradient's largest element, against the plain version and the
Pallas kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.models.bert import BertEncoder as JaxBert
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.ops.pallas_attention import fused_attention as jax_fused_attention

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import state_dict_from_jax
from hop_tpu_torch.models.bert import BertEncoder
from hop_tpu_torch.ops import attention as K4
from hop_tpu_torch.ops.dropout import attention_keep

SHAPES = [(2, 34, 4, 16), (3, 10, 2, 8), (16, 34, 2, 8)]
GRAD_REL = 1e-4
EMULATION_TOL = 1e-5        # of the largest |v|
# one 16-key step (10), whole steps (16, 64), one row past a step (17), the
# backbone's (34), an odd count of 8-key tiles (40)
TILED_T = [10, 16, 17, 34, 40, 64]
# the backward's: also one row short of a 16-row tile past two (33)
TILED_BWD_T = TILED_T + [33]
EMULATION_BWD_REL = 2e-5    # of each gradient's largest element


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_ATTN", "interpret")


def inputs(shape, seed, n=4):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


def bf16_exact(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrays]


def assert_emulation_close(got, want, v):
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=EMULATION_TOL * v.abs().max().item())


def einsum_attention(q, k, v, scale, keep=None):
    """The backbone's plain route (models/bert.py), with a given mask."""
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    if keep is not None:
        p = p * keep
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def assert_grads_close(got, want, rel=GRAD_REL):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = torch.tensor(np.asarray(b))
        torch.testing.assert_close(a, b, rtol=0, atol=rel * b.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_pallas(shape):
    q, k, v = inputs(shape, seed=shape[0], n=3)
    scale = shape[-1] ** -0.5
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray([0], jnp.int32), scale, 0.0)
    got = K4.fused_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradients_match_pallas_and_autograd(shape):
    q, k, v, g = inputs(shape, seed=10 + shape[0])
    scale = 0.3
    seed = jnp.asarray([0], jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_fused_attention(q, k, v, seed, scale, 0.0),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    got = K4.fused_attention_bwd(tq, tk, tv, tg, scale)
    assert_grads_close(got, vjp(jnp.asarray(g)))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    assert_grads_close(got, torch.autograd.grad(
        einsum_attention(*leaves, scale), leaves, tg))
    # the autograd Function gives the same
    assert_grads_close(torch.autograd.grad(
        K4.fused_attention(*leaves, scale), leaves, tg), got, rel=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", TILED_T)
def test_tiled_forward_matches_plain_version(T, rate):
    q, k, v = bf16_exact(inputs((3, T, 2, 16), seed=T, n=3))
    got = K4.tiled_fused_attention(q, k, v, 0.25, rate, 11)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert_emulation_close(got, K4.plain_fused_attention(q, k, v, 0.25, rate, 11), v)
    if rate > 0.0:      # the mask took effect: the plain version's
        assert (got - K4.plain_fused_attention(q, k, v, 0.25)).abs().max().item() > 1e-2


@pytest.mark.parametrize("T", TILED_T)
def test_tiled_forward_matches_pallas(T):
    q, k, v = bf16_exact(inputs((2, T, 3, 16), seed=100 + T, n=3))
    want = jax_fused_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               jnp.asarray([0], jnp.int32), 0.25, 0.0)
    assert_emulation_close(K4.tiled_fused_attention(q, k, v, 0.25), want, v)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", TILED_BWD_T)
def test_tiled_backward_matches_plain_version(T, rate):
    q, k, v, g = bf16_exact(inputs((3, T, 2, 16), seed=T))
    got = K4.tiled_fused_attention_bwd(q, k, v, g, 0.25, rate, 11)
    assert all(t.dtype == torch.float32 and t.shape == q.shape for t in got)
    assert_grads_close(got, K4.plain_fused_attention_bwd(q, k, v, g, 0.25, rate, 11),
                       EMULATION_BWD_REL)
    if rate > 0.0:      # the mask took effect: the plain version's
        undropped = K4.plain_fused_attention_bwd(q, k, v, g, 0.25)
        assert all((a - b).abs().max().item() > 1e-2 for a, b in zip(got, undropped))


@pytest.mark.parametrize("T", TILED_BWD_T)
def test_tiled_backward_matches_pallas(T):
    q, k, v, g = bf16_exact(inputs((2, T, 3, 16), seed=200 + T))
    seed = jnp.asarray([0], jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_fused_attention(q, k, v, seed, 0.25, 0.0),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    assert_grads_close(K4.tiled_fused_attention_bwd(q, k, v, g, 0.25),
                       vjp(jnp.asarray(g.numpy())), EMULATION_BWD_REL)


def test_gradcheck_float64():
    r = np.random.default_rng(0)
    q, k, v = (torch.tensor(r.standard_normal((2, 5, 2, 4)), requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: K4.fused_attention(a, b, c, 0.4, 0.2, 3), (q, k, v))


def test_dropout_rate_and_seeds():
    shape = (8, 34, 4, 16)
    q, k, v = map(torch.from_numpy, inputs(shape, seed=2, n=3))
    B, T, H, _ = shape
    rate = 0.1
    keep = attention_keep(11, rate, B, T, H, T, "cpu") > 0
    n = keep.numel()                                     # 36992 draws
    assert abs(keep.float().mean().item() - (1 - rate)) < 3 * (rate * (1 - rate) / n) ** 0.5
    a = K4.fused_attention(q, k, v, 0.25, rate, 11)
    assert torch.equal(a, K4.fused_attention(q, k, v, 0.25, rate, 11))
    assert not torch.allclose(a, K4.fused_attention(q, k, v, 0.25, rate, 12))
    assert not torch.allclose(a, K4.fused_attention(q, k, v, 0.25))
    other = attention_keep(12, rate, B, T, H, T, "cpu") > 0
    assert (other != keep).float().mean().item() > 0.1
    # a mask bit is a function of global coordinates: the first samples of a
    # larger batch get the mask they get alone
    torch.testing.assert_close(
        K4.fused_attention(q[:3], k[:3], v[:3], 0.25, rate, 11), a[:3],
        rtol=0, atol=1e-6)


def test_dropout_backward_uses_the_forward_mask():
    """The gradient equals autograd through the plain route with the mask of
    `attention_keep`: a redrawn or stale backward mask would be off by about
    the dropout rate."""
    shape = (3, 34, 2, 8)
    q, k, v, g = map(torch.from_numpy, inputs(shape, seed=3))
    B, T, H, _ = shape
    scale, rate, seed = 0.35, 0.3, 5
    keep = attention_keep(seed, rate, B, T, H, T, "cpu")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = einsum_attention(*leaves, scale, keep)
    want = torch.autograd.grad(want_out, leaves, g)
    got_out = K4.fused_attention(*leaves, scale, rate, seed)
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=1e-5)
    assert_grads_close(torch.autograd.grad(got_out, leaves, g), want)
    assert_grads_close(K4.fused_attention_bwd(q, k, v, g, scale, rate, seed), want)


def _jax_backbone(seed):
    """A tiny JAX HOPModel's variables (numpy) and its f32 config; the
    backbone's weights are its `llm` subtree."""
    cfg = jcfg.tiny_test_config("TED")
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False))
    d = cfg.data
    model = JaxHOP(cfg, n_speakers=3)
    variables = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((1, d.expected_audio_length)),
        jnp.zeros((1, d.n_poses, d.mel_bins)), jnp.zeros((1, d.n_poses), jnp.int32),
        jnp.zeros((1, d.n_seed_frames, d.pose_dim)), jnp.zeros((1,), jnp.int32),
        rng=key))(jax.random.PRNGKey(seed))
    return cfg, jax.tree_util.tree_map(np.asarray, flax_meta.unbox(variables))


def check_encoder_route(route, monkeypatch, env_var):
    """The port's BertEncoder on `route` against its plain route and against
    the JAX BertEncoder with `env_var` set to interpret, weights carried by
    `state_dict_from_jax`."""
    jcfg_, variables = _jax_backbone(seed=4)
    cfg = tcfg.tiny_test_config("TED")
    llm = dataclasses.replace(cfg.llm, compute_bf16=False, attention=route)
    sd = state_dict_from_jax(variables, cfg.replace(llm=llm))
    sd = {k[len("llm_model."):]: v for k, v in sd.items() if k.startswith("llm_model.")}
    enc = BertEncoder(llm).eval()
    enc.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).standard_normal((3, 34, llm.dim)).astype(np.float32)
    with torch.inference_mode():
        got = enc(torch.from_numpy(x))
        enc.set_attention("plain")
        plain = enc(torch.from_numpy(x))
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
    monkeypatch.setenv("HOP_TPU_PALLAS_ATTN", "0")
    monkeypatch.setenv("HOP_TPU_PALLAS_BLOCK_ATTN", "0")
    monkeypatch.setenv(env_var, "interpret")
    want = JaxBert(jcfg_.llm).apply({"params": variables["params"]["llm"]},
                                    jnp.asarray(x), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_bert_encoder_on_the_fused_route(monkeypatch):
    check_encoder_route("fused", monkeypatch, "HOP_TPU_PALLAS_ATTN")


def test_encoder_dropout_on_the_kernel_route():
    """With dropout on, the layers draw different masks from one `attn_seed`
    folded with their index, the same call repeats, and another seed gives
    another output; an unknown route is refused."""
    llm = dataclasses.replace(tcfg.tiny_test_config("TED").llm, compute_bf16=False,
                              attention="fused")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc = BertEncoder(llm)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 34, llm.dim)).astype(np.float32))

    def run(attn_seed):
        with torch.inference_mode():
            return enc(x, deterministic=False,
                       generator=torch.Generator().manual_seed(3), attn_seed=attn_seed)
    a = run(7)
    assert torch.equal(a, run(7))
    assert not torch.allclose(a, run(8))
    from hop_tpu_torch.ops.dropout import fold_seed
    seeds = {fold_seed(7, i) for i in range(6)} | {fold_seed(8, i) for i in range(6)}
    assert len(seeds) == 12 and all(0 <= s < 2 ** 32 for s in seeds)
    with pytest.raises(ValueError, match="attention"):
        BertEncoder(dataclasses.replace(llm, attention="flash"))
    with pytest.raises(ValueError, match="route"):
        enc.set_attention("flash")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 34, 4, 16)
    with pytest.raises(ValueError, match="D == 64"):
        K4.check_operands("fused_attention", q, q, q, K4.MAX_T)
    q = torch.zeros(2, 65, 4, 64)
    with pytest.raises(ValueError, match="T <= 64"):
        K4.check_operands("fused_attention", q, q, q, K4.MAX_T)
    with pytest.raises(ValueError, match="share one"):
        K4.check_operands("fused_attention", q, q[:1], q, K4.MAX_T)
