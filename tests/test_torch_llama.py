"""The port's LLaMA backbone (hop_tpu_torch.models.llama) against hop_tpu's
and HF's, and HOP on it: the encoder (n_kv_heads None and 2), its RoPE
tables and token path, `transformers.LlamaModel` on the same weights, HOP's
forward on both GRU routes, one fused warmup and GAN step against
hop_tpu.train.llm, and the backbone's place in the optimizers and
checkpoints (7B geometry, on the meta device).

Both sides run in f32 with the backbone's bf16 products off
(compute_bf16=False). Tolerances: the encoder 1e-5 absolute (f32 round-off
through 2 layers of O(1) activations); the HOP forward 1e-5 on outputs of
O(0.1-1), K1 and the GRU on the JAX side in interpret mode as
tests/test_torch_hop_model.py runs them; the step at
tests/test_torch_train_step.py's tolerances (losses 2e-5 relative, each
gradient 1e-4 of its largest element), JAX's draws handed in.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.models import llama as jllama
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.train.llm import make_hop_train_steps as jax_make_steps

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import (_llama, discriminator_state_dict_from_jax,
                                   state_dict_from_jax)
from hop_tpu_torch.models import llama
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.train.llm import make_hop_train_steps
from hop_tpu_torch.utils.checkpoint import strip_frozen

from test_torch_train_step import (BATCH_KEYS, LOSS_RTOL, STEP_KEY, _assert_grads,
                                   _assert_params, _grads, _no_dropout, _numpy,
                                   jax_noise)

ENC_TOL = 1e-5
HOP_TOL = 1e-5
N_SPEAKERS = 7
B_STEP = 4
STEP_VARIANTS = [("warmup", 1), ("gan", 1)]


def _llm(n_kv=2, **kw):
    """The port's thin LLaMA in f32, and hop_tpu's LLMConfig of the same."""
    port = dataclasses.replace(tcfg.tiny_llama_llm_config(), n_kv_heads=n_kv,
                               compute_bf16=False, **kw)
    jax_fields = {f.name for f in dataclasses.fields(jcfg.LLMConfig)}
    ref = jcfg.LLMConfig(**{k: v for k, v in dataclasses.asdict(port).items()
                            if k in jax_fields})
    return port, ref


def _jax_encoder(ref, seed):
    enc = jllama.LlamaEncoder(ref)
    x = jnp.zeros((1, 5, ref.dim))
    params = jax.jit(lambda key: enc.init(key, x))(jax.random.PRNGKey(seed))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(params))
    # the RMSNorm scales away from 1, so that they are exercised
    r = np.random.default_rng(seed + 1)
    norms = [params["final_norm"]] + [params[f"layer_{i}"][n] for i in range(ref.n_layers)
                                      for n in ("input_ln", "post_attention_ln")]
    for norm in norms:
        norm["scale"] = r.uniform(0.5, 1.5, norm["scale"].shape).astype(np.float32)
    # word_embeddings is initialised by encode_tokens only
    params["word_embeddings"] = {"embedding": r.normal(
        0, 0.02, (ref.vocab_size, ref.dim)).astype(np.float32)}
    return enc, params


def _port_encoder(port, params):
    enc = llama.LlamaEncoder(port)
    sd = {}
    _llama(sd, "", params, port.n_layers)
    enc.load_state_dict(sd, strict=True)
    return enc


@pytest.mark.parametrize("n_kv", [None, 2], ids=["mha", "gqa"])
def test_encoder_matches_jax(n_kv):
    port, ref = _llm(n_kv)
    jenc, params = _jax_encoder(ref, seed=0)
    enc = _port_encoder(port, params)
    x = np.random.default_rng(1).normal(size=(3, 34, port.dim)).astype(np.float32)
    want = jenc.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = enc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ENC_TOL)


def test_token_path_matches_jax():
    port, ref = _llm()
    jenc, params = _jax_encoder(ref, seed=2)
    enc = _port_encoder(port, params)
    ids = np.random.default_rng(3).integers(0, port.vocab_size, (2, 9))
    want = jenc.apply({"params": params}, jnp.asarray(ids), method=jenc.encode_tokens)
    with torch.inference_mode():
        got = enc(enc.embed_tokens(torch.from_numpy(ids)))
        assert torch.equal(enc.word_embeddings[torch.from_numpy(ids)],
                           enc.embed_tokens(torch.from_numpy(ids)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ENC_TOL)


@pytest.mark.parametrize("T,head_dim,theta", [(34, 16, 1e4), (7, 128, 5e5)])
def test_rope_tables_match_jax(T, head_dim, theta):
    cos, sin = llama.rope_cos_sin(T, head_dim, theta)
    jcos, jsin = jllama.rope_cos_sin(T, head_dim, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=1e-6)
    x = np.random.default_rng(4).normal(size=(2, T, 3, head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        llama.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jllama.apply_rope(jnp.asarray(x), jcos, jsin)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_kv", [None, 2], ids=["mha", "gqa"])
def test_encoder_matches_transformers(n_kv):
    """HF LlamaModel's own state_dict loads by name (strict) and its forward
    over inputs_embeds is the port's, eager attention, f32."""
    transformers = pytest.importorskip("transformers")
    port, _ = _llm(n_kv)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=port.vocab_size, hidden_size=port.dim,
        intermediate_size=port.intermediate_dim, num_hidden_layers=port.n_layers,
        num_attention_heads=port.n_heads,
        num_key_value_heads=port.n_kv_heads or port.n_heads,
        max_position_embeddings=port.max_position, rms_norm_eps=port.rms_norm_eps,
        rope_theta=port.rope_theta, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.LlamaModel(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("layernorm.weight") or name == "norm.weight":
                p.uniform_(0.5, 1.5)
    enc = llama.LlamaEncoder(port)
    enc.load_state_dict(hf.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 34, port.dim)).astype(np.float32))
    with torch.inference_mode():
        want = hf(inputs_embeds=x).last_hidden_state
        got = enc(x)
    torch.testing.assert_close(got, want, rtol=0, atol=ENC_TOL)


def test_bf16_products_stay_close_to_f32():
    """compute_bf16: products in bf16, the rest in f32, as hop_tpu's; the
    outputs of the two precisions agree to bf16 round-off through the
    layers (2^-8 relative a product: 5e-2 absolute on O(1) outputs)."""
    port, ref = _llm()
    _, params = _jax_encoder(ref, seed=6)
    enc = _port_encoder(port, params)
    enc16 = _port_encoder(dataclasses.replace(port, compute_bf16=True), params)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 34, port.dim)).astype(np.float32))
    with torch.inference_mode():
        got, want = enc16(x), enc(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("route", ["fused", "block"])
def test_kernel_attention_routes_are_refused(route):
    port, _ = _llm()
    with pytest.raises(ValueError, match="LLaMA takes attention='plain' only"):
        llama.LlamaEncoder(dataclasses.replace(port, attention=route))


def test_presets_match_jax():
    for port, ref in ((tcfg.llama7b_llm_config(), jcfg.llama7b_llm_config()),
                      (tcfg.llama7b_llm_config(2), jcfg.llama7b_llm_config(2))):
        for f in dataclasses.fields(ref):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    tiny = tcfg.tiny_llama_llm_config()
    assert (tiny.model, tiny.dim, tiny.n_layers, tiny.n_heads, tiny.n_kv_heads,
            tiny.intermediate_dim, tiny.vocab_size) == ("LLAMA", 64, 2, 4, 2, 128, 128)


# --- HOP on the LLaMA backbone ---

def _hop_cfgs(gru_kernel="fused"):
    port_llm, ref_llm = _llm()
    ref = jcfg.tiny_test_config("TED").replace(llm=ref_llm)
    port = tcfg.tiny_test_config("TED")
    port = port.replace(llm=port_llm,
                        hop=dataclasses.replace(port.hop, gru_kernel=gru_kernel))
    return port, ref


def _hop_inputs(cfg, B, seed):
    r = np.random.default_rng(seed)
    d = cfg.data
    return dict(
        in_audio=r.normal(size=(B, d.expected_audio_length)).astype(np.float32),
        x_enc=r.normal(size=(B, d.n_poses, d.mel_bins)).astype(np.float32),
        text=r.integers(0, cfg.llm.vocab_size, size=(B, d.n_poses)).astype(np.int32),
        pre_seq=r.normal(size=(B, d.n_seed_frames, d.pose_dim)).astype(np.float32),
        vid_indices=r.integers(0, N_SPEAKERS, size=(B,)).astype(np.int32))


@pytest.mark.parametrize("gru_kernel,gru_env", [("fused", "interpret-fused"),
                                                ("stack", "interpret")])
def test_hop_forward_matches_jax(monkeypatch, gru_kernel, gru_env):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", gru_env)
    cfg, ref = _hop_cfgs(gru_kernel)
    jmodel = JaxHOP(ref, n_speakers=N_SPEAKERS)
    inputs = _hop_inputs(ref, 3, seed=1)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.jit(lambda key: jmodel.init({"params": key}, **jin, rng=key))(
        jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(variables))
    key = jax.random.PRNGKey(5)
    want, z_want, _, _ = jax.jit(
        lambda v, key, **kw: jmodel.apply(v, **kw, rng=key, train=False))(
        variables, key, **jin)
    eps = np.array(jax.random.normal(key, (3, ref.hop.z_size), jnp.float32))

    model = HOPModel(cfg, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    assert isinstance(model.llm_model, llama.LlamaEncoder)
    assert model.gru.kernel == gru_kernel
    with torch.inference_mode():
        got, z, _, _ = model(*(torch.from_numpy(inputs[k]) for k in
                               ("in_audio", "x_enc", "text", "pre_seq", "vid_indices")),
                             eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=HOP_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=0, atol=HOP_TOL)


@pytest.fixture(scope="module")
def jax_llama_steps():
    """hop_tpu's fused warmup and GAN step (epoch 1) on the thin LLaMA, f32,
    dropout off: the initial variables, the batch and each step's metrics,
    gradients (2 mu of Adam's first step) and new state."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOP_TPU_PALLAS_REPROG", raising=False)
        mp.delenv("HOP_TPU_PALLAS_GRU", raising=False)
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        _, cfg = _hop_cfgs()
        nb = jsynthetic.make_batch(cfg, B_STEP, seed=0)
        nb["text_padded"] = nb["text_padded"] % cfg.llm.vocab_size
        nb = jsynthetic.add_device_features(nb, cfg)
        batch = {k: np.asarray(nb[k]) for k in BATCH_KEYS}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        model, disc = JaxHOP(cfg, n_speakers=10), JaxDisc()
        gen_vars = jax.jit(lambda key: model.init(
            {"params": key, "dropout": key}, jb["in_audio"], jb["log_mel"],
            jb["text_padded"], jb["target_vec"][:, :16], jb["vid_indices"],
            rng=key, train=True))(jax.random.PRNGKey(0))
        dis_vars = jax.jit(lambda key: disc.init(
            {"params": key, "dropout": key}, jb["target_vec"], train=True))(
            jax.random.PRNGKey(2))
        init = {"gen": _numpy(gen_vars), "dis": _numpy(dis_vars)}
        warmup, gan, init_state = jax_make_steps(cfg, model, disc)
        runs = {}
        for kind, epoch in STEP_VARIANTS:
            step = (warmup if kind == "warmup" else gan).for_epoch(epoch)
            state, metrics = step(init_state(gen_vars, dis_vars), jb,
                                  jax.random.PRNGKey(STEP_KEY))
            gen_mu = _numpy(state.gen_opt_state.inner_states["train"].inner_state[0].mu)
            gen_mu.pop("llm")
            runs[kind] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                gen_grads={k: jax.tree_util.tree_map(lambda m: 2.0 * m, v)
                           for k, v in gen_mu.items()},
                dis_grads=jax.tree_util.tree_map(lambda m: 2.0 * m,
                                                 _numpy(state.dis_opt_state[0].mu)),
                gen={"params": _numpy(state.gen_params),
                     "batch_stats": _numpy(state.gen_stats)},
                dis={"params": _numpy(state.dis_params),
                     "batch_stats": _numpy(state.dis_stats)})
    return cfg, batch, init, runs


@pytest.mark.parametrize("kind,epoch", STEP_VARIANTS)
def test_fused_step_matches_jax(jax_llama_steps, kind, epoch):
    """One fused step on the thin LLaMA against hop_tpu's: losses, both
    nets' gradients and updated parameters; the backbone bit-unchanged and
    in neither optimizer."""
    cfg_j, batch, init, runs = jax_llama_steps
    want = runs[kind]
    cfg, _ = _hop_cfgs()
    model = HOPModel(cfg, n_speakers=10)
    model.load_state_dict(state_dict_from_jax(init["gen"], cfg), strict=True)
    disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(discriminator_state_dict_from_jax(init["dis"]), strict=True)
    model.reprogramming_layer.attention_dropout = 0.0
    disc.gru.dropout = 0.0
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    state = init_state()
    backbone = {id(p) for p in model.llm_model.parameters()}
    for opt in (state.gen_opt, state.dis_opt):
        assert not any(id(p) in backbone for g in opt.param_groups for p in g["params"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = (warmup if kind == "warmup" else gan).for_epoch(epoch)
    state, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()},
                          jax_noise(cfg_j, batch))

    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    gen_grads = {**init["gen"]["params"], **want["gen_grads"]}
    want_g = state_dict_from_jax({"params": gen_grads,
                                  "batch_stats": init["gen"]["batch_stats"]}, cfg)
    g_tols = _assert_grads(_grads(model), want_g, "generator")
    lr = cfg.train.learning_rate
    _assert_params(model, state_dict_from_jax(want["gen"], cfg), want_g, g_tols, lr)
    if kind == "gan":
        want_d = discriminator_state_dict_from_jax(
            {"params": want["dis_grads"], "batch_stats": init["dis"]["batch_stats"]})
        d_tols = _assert_grads(_grads(disc), want_d, "discriminator")
        _assert_params(disc, discriminator_state_dict_from_jax(want["dis"]), want_d,
                       d_tols, lr * cfg.train.dis_lr_scale)
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("llm_model."):
            assert torch.equal(after[k], v), f"frozen {k} changed"
    for k in ("align_layer.weight", "mapping_layer.weight"):
        assert not torch.equal(after[k], before[k]), f"{k} did not move"


def test_7b_checkpoint_carries_no_backbone():
    """At LLaMA-7B's geometry (on the meta device: shapes, no memory) the
    saved generator holds no backbone array (1.345 B elements); what it
    holds is the trainable part and the BatchNorm statistics, whose size is
    stated here: the prototype mapping (1500 x 32000) and align_layer
    (8192 -> 4096) are 81.6 M of its 117.5 M."""
    cfg = tcfg.ted_config().replace(llm=tcfg.llama7b_llm_config(6))
    with torch.device("meta"):
        model = HOPModel(cfg, n_speakers=1000)
    saved, frozen = strip_frozen(model.state_dict())
    assert frozen and not any(k.startswith("llm_model.") for k in saved)
    n_frozen = sum(v.numel() for v in frozen.values())
    n_saved = sum(v.numel() for v in saved.values())
    assert n_frozen == 6 * 202_383_360 + 131_076_096       # 1.345 B
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert n_saved == trainable + sum(b.numel() for b in model.buffers())
    # 117.5 M elements: 0.47 GB in f32, 1.41 GB with Adam's m and v
    assert n_saved == 117_471_580, n_saved
