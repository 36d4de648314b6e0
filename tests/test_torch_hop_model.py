"""The port's HOPModel (hop_tpu_torch) against the JAX HOPModel, weights
converted with `state_dict_from_jax`: the whole forward for TED and
expressive, the trunk alone, and the log-mel frontend.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do (HOP_TPU_PALLAS_REPROG=interpret, HOP_TPU_PALLAS_GRU=interpret-fused),
with f32 matmuls (conftest.py). Both sides run in f32 with the backbone's
bf16 matmuls off (compute_bf16=False), so the tolerance is float32
round-off through ~20 layers: 1e-4 absolute on outputs of O(0.1-1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.ops import mel as jmel

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import state_dict_from_jax
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.ops import mel as tmel

TOL = 1e-4
N_SPEAKERS = 7


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", "interpret-fused")


def _f32(cfg):
    return cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False))


def _inputs(cfg, B, seed):
    r = np.random.default_rng(seed)
    d = cfg.data
    return dict(
        in_audio=r.normal(size=(B, d.expected_audio_length)).astype(np.float32),
        x_enc=r.normal(size=(B, d.n_poses, d.mel_bins)).astype(np.float32),
        text=r.integers(0, cfg.llm.vocab_size, size=(B, d.n_poses)).astype(np.int32),
        pre_seq=r.normal(size=(B, d.n_seed_frames, d.pose_dim)).astype(np.float32),
        vid_indices=r.integers(0, N_SPEAKERS, size=(B,)).astype(np.int32),
    )


def _jax_model(dataset, seed):
    """JAX tiny model and numpy variables; gwnet's BN statistics are set
    away from (0, 1) so the eval-mode normalisation is exercised."""
    cfg = _f32(jcfg.tiny_test_config(dataset))
    model = JaxHOP(cfg, n_speakers=N_SPEAKERS)
    inputs = {k: jnp.asarray(v) for k, v in _inputs(cfg, 1, seed).items()}
    variables = jax.jit(lambda key: model.init(
        {"params": key}, **inputs, rng=key))(jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(variables))
    r = np.random.default_rng(seed + 100)
    for bn in variables["batch_stats"]["gwnet"].values():
        bn["mean"] = r.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return cfg, model, variables


def _port_model(dataset, jax_variables, gru_kernel="fused", attention="plain"):
    cfg = _f32(tcfg.tiny_test_config(dataset))
    cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, gru_kernel=gru_kernel),
                      llm=dataclasses.replace(cfg.llm, attention=attention))
    model = HOPModel(cfg, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(jax_variables, cfg), strict=True)
    return model


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_forward_matches_jax(dataset):
    _check_forward(dataset, "fused")


def test_forward_on_the_stack_route_matches_jax(monkeypatch):
    """The whole forward with `gru_kernel="stack"` (projection product + K3's
    plain version) against the JAX model on its time-grid kernel."""
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", "interpret")
    _check_forward("TED", "stack")


@pytest.mark.parametrize("attention,env_var", [
    ("fused", "HOP_TPU_PALLAS_ATTN"), ("block", "HOP_TPU_PALLAS_BLOCK_ATTN")])
def test_forward_on_the_kernel_attention_routes_matches_jax(monkeypatch, attention,
                                                            env_var):
    """The whole forward with the backbone's attention on K4's or K5's plain
    version against the JAX model with the matching Pallas kernel in
    interpret mode."""
    monkeypatch.setenv(env_var, "interpret")
    _check_forward("TED", "fused", attention)


def _check_forward(dataset, gru_kernel, attention="plain"):
    jcfg_, jmodel, variables = _jax_model(dataset, seed=0)
    model = _port_model(dataset, variables, gru_kernel, attention)
    assert model.gru.kernel == gru_kernel
    assert all(l.route == attention for l in model.llm_model.encoder.layer)
    B = 3
    inputs = _inputs(jcfg_, B, seed=1)
    key = jax.random.PRNGKey(5)
    want, z_want, mu_want, logvar_want = jax.jit(
        lambda v, key, **kw: jmodel.apply(v, **kw, rng=key, train=False))(
        variables, key, **inputs)
    # the same speaker noise the JAX SpeakerLatent draws from `key`
    eps = np.asarray(jax.random.normal(key, (B, jcfg_.hop.z_size), jnp.float32))

    with torch.inference_mode():
        got, z, mu, logvar = model(
            *(torch.from_numpy(inputs[k]) for k in
              ("in_audio", "x_enc", "text", "pre_seq", "vid_indices")),
            eps=torch.from_numpy(eps))
    assert got.shape == (B, jcfg_.data.n_poses, jcfg_.data.pose_dim)
    for name, a, b in (("out", got, want), ("z", z, z_want), ("mu", mu, mu_want),
                       ("logvar", logvar, logvar_want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=name)


def test_trunk_matches_jax():
    jcfg_, jmodel, variables = _jax_model("TED", seed=2)
    model = _port_model("TED", variables)
    inputs = _inputs(jcfg_, 2, seed=3)
    args = [inputs[k] for k in ("in_audio", "x_enc", "text", "pre_seq")]
    want = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=JaxHOP.trunk))(variables, *args)
    with torch.inference_mode():
        got = model.trunk(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_mel_matches_jax():
    """The tests/test_mel.py cases, port against hop_tpu.ops.mel."""
    r = np.random.default_rng(0)
    y = r.normal(size=4096).astype(np.float32)
    np.testing.assert_allclose(
        tmel.power_spectrogram(torch.from_numpy(y), n_fft=1024, hop=512).numpy(),
        np.asarray(jmel.power_spectrogram(y, n_fft=1024, hop=512)),
        rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tmel.mel_filterbank(16000, 1024, 128),
                                  jmel.mel_filterbank(16000, 1024, 128))
    s = np.abs(r.normal(size=(3, 10, 8))).astype(np.float32)
    s[1] *= 100.0
    np.testing.assert_allclose(
        tmel.power_to_db(torch.from_numpy(s), ref_axes=(-2, -1)).numpy(),
        np.asarray(jmel.power_to_db(jnp.asarray(s), ref_axes=(-2, -1))),
        rtol=0, atol=1e-4)
    # the serving shape (34 frames at hop 1096) and a batched short signal;
    # log-mel in dB, where f32 round-off of the DFT shows as ~1e-3 dB
    for audio in (r.normal(size=(2, 36267)), r.normal(size=(2, 8192))):
        audio = audio.astype(np.float32)
        got = tmel.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
        want = np.asarray(jmel.log_mel_spectrogram(audio))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
