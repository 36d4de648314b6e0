"""Weights across frameworks: `state_dict_from_jax` and
`discriminator_state_dict_from_jax` round-trip through the existing
importers, and the port's BERT takes a HuggingFace BertModel's weights
under HF's names and gives HF's outputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.eval.torch_import_generator import convert_conv_discriminator
from hop_tpu.eval.torch_import_hop import convert_hop_model
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import (discriminator_state_dict_from_jax,
                                   state_dict_from_jax)
from hop_tpu_torch.models.bert import BertEncoder, make_llm_encoder
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator


def _jax_variables(dataset):
    cfg = jcfg.tiny_test_config(dataset)
    d = cfg.data
    model = JaxHOP(cfg, n_speakers=5)
    variables = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((1, d.expected_audio_length)),
        jnp.zeros((1, d.n_poses, d.mel_bins)), jnp.zeros((1, d.n_poses), jnp.int32),
        jnp.zeros((1, d.n_seed_frames, d.pose_dim)), jnp.zeros((1,), jnp.int32),
        rng=key))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, flax_meta.unbox(variables))


def test_state_dict_round_trips_through_importer():
    """port state_dict -> hop_tpu.eval.torch_import_hop.convert_hop_model
    gives back the original flax tree, every leaf bit for bit."""
    for dataset in ("TED", "TED_expressive"):
        variables = _jax_variables(dataset)
        model = HOPModel(tcfg.tiny_test_config(dataset), n_speakers=5)
        model.load_state_dict(state_dict_from_jax(
            variables, tcfg.tiny_test_config(dataset)), strict=True)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        back = convert_hop_model(sd, jcfg.tiny_test_config(dataset))
        want = jax.tree_util.tree_flatten_with_path(variables)
        got = jax.tree_util.tree_flatten_with_path(back)
        assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
        for (path, a), (_, b) in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def _assert_same_tree(got, want):
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def _jax_discriminator(seed=0):
    disc = JaxDisc()
    poses = jnp.asarray(np.random.default_rng(seed).normal(size=(3, 34, 27)),
                        jnp.float32)
    variables = jax.jit(lambda key: disc.init(
        {"params": key, "dropout": key}, poses, train=True))(
        jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(variables))
    r = np.random.default_rng(seed + 1)
    for bn in variables["batch_stats"].values():
        s = bn["BatchNorm_0"]
        s["mean"] = r.normal(0, 0.3, s["mean"].shape).astype(np.float32)
        s["var"] = r.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
    return disc, variables, poses


def test_discriminator_round_trips_through_importer():
    """port ConvDiscriminator state_dict -> hop_tpu's
    convert_conv_discriminator gives back the flax tree, bit for bit."""
    _, variables, _ = _jax_discriminator()
    disc = ConvDiscriminator(pose_dim=27)
    disc.load_state_dict(discriminator_state_dict_from_jax(variables), strict=True)
    sd = {k: v.numpy() for k, v in disc.state_dict().items()}
    _assert_same_tree(convert_conv_discriminator(sd), variables)


def test_discriminator_eval_forward_matches_jax():
    """Eval mode (running BatchNorm statistics, no dropout): f32 round-off
    through three convs and four BiGRU layers, 1e-5 on outputs in (0, 1)."""
    jdisc, variables, poses = _jax_discriminator(seed=4)
    want = jdisc.apply(variables, poses, train=False)
    disc = ConvDiscriminator(pose_dim=27).eval()
    disc.load_state_dict(discriminator_state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        got = disc(torch.tensor(np.asarray(poses)))
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_bert_matches_huggingface():
    from transformers import BertConfig, BertModel
    cfg = dataclasses.replace(tcfg.tiny_test_config().llm, compute_bf16=False)
    torch.manual_seed(0)
    hf = BertModel(BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        intermediate_size=cfg.intermediate_dim,
        max_position_embeddings=cfg.max_position, hidden_act="gelu"),
        add_pooling_layer=False).eval()
    bert = BertEncoder(cfg)
    bert.load_state_dict(hf.state_dict(), strict=True)
    x = torch.randn(2, 34, cfg.dim)
    with torch.inference_mode():
        want = hf(inputs_embeds=x).last_hidden_state
        got = bert(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_llm_dispatch():
    """The backbone factory ports only BERT; LLaMA is queued, anything else
    is rejected as in the reference."""
    cfg = tcfg.tiny_test_config().llm
    assert isinstance(make_llm_encoder(cfg), BertEncoder)
    with pytest.raises(NotImplementedError, match="M14"):
        make_llm_encoder(dataclasses.replace(cfg, model="LLAMA"))
    with pytest.raises(ValueError, match="not defined"):
        make_llm_encoder(dataclasses.replace(cfg, model="GPT2"))
