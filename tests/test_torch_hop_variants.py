"""HOP's two ablations in the port (`HOPConfig.use_gwnet=False`,
`use_reprogramming=False`; hop_tpu/models/hop.py:52-60, :154-190) against
hop_tpu's, at tiny_test_config("TED") in f32 with B = 4, inputs from a
numpy seed: the converters' round trip (hop_tpu's variables -> the port's
state_dict -> hop_tpu's `convert_hop_model` -> the same variables, bitwise);
the eval-mode forward with JAX's speaker noise handed in, to 1e-5 of the
output's largest element; and one fused warmup step (the steady variant)
from identical state, under tests/test_torch_train_step.py's helpers and
tolerances (dropout off on both sides, JAX's draws handed in as the port's
`StepNoise`; the WavEncoder's first bias in the no-gwnet variant is
test_torch_zoo_steps.py's `ROUND_OFF_SUMS` case)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.eval.torch_import_hop import convert_hop_model
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.train.llm import make_hop_train_steps as jax_make_steps

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from hop_tpu_torch.models.hop import HOPModel, gru_input_size
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.train.llm import make_hop_train_steps

from test_torch_train_step import (B, BATCH_KEYS, N_SPEAKERS, STEP_KEY, _f32, _no_dropout,
                                   _numpy, jax_noise)
from test_torch_zoo_steps import _check_metrics, _check_net, _grads, one_torch_thread  # noqa: F401

VARIANTS = {"no_gwnet": dict(use_gwnet=False), "no_reprogramming": dict(use_reprogramming=False)}


def _cfg(module, variant):
    cfg = _f32(module.tiny_test_config("TED"))
    return cfg.replace(hop=dataclasses.replace(cfg.hop, **VARIANTS[variant]))


@pytest.fixture(scope="module")
def jax_runs():
    """For each variant: hop_tpu's variables, its eval forward and one fused
    warmup step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOP_TPU_PALLAS_REPROG", raising=False)
        mp.delenv("HOP_TPU_PALLAS_GRU", raising=False)
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        runs = {}
        for variant in VARIANTS:
            cfg = _cfg(jcfg, variant)
            nb = jsynthetic.make_batch(cfg, B, seed=0)
            nb["text_padded"] = nb["text_padded"] % cfg.llm.vocab_size
            nb = jsynthetic.add_device_features(nb, cfg)
            batch = {k: np.asarray(nb[k]) for k in BATCH_KEYS}
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            model, disc = JaxHOP(cfg, n_speakers=N_SPEAKERS), JaxDisc()
            args = (jb["in_audio"], jb["log_mel"], jb["text_padded"], jb["target_vec"][:, :16],
                    jb["vid_indices"])
            gen_vars = _numpy(jax.jit(lambda key: model.init(
                {"params": key, "dropout": key}, *args, rng=key, train=True))(
                jax.random.PRNGKey(0)))
            r = np.random.default_rng(3)
            for bn in jax.tree_util.tree_leaves(
                    gen_vars["batch_stats"], is_leaf=lambda t: isinstance(t, dict) and "mean" in t):
                bn["mean"] = r.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
                bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
            dis_vars = _numpy(jax.jit(lambda key: disc.init(
                {"params": key, "dropout": key}, jb["target_vec"], train=True))(
                jax.random.PRNGKey(2)))
            key = jax.random.PRNGKey(5)
            forward = jax.jit(lambda v, *a: model.apply(v, *a, rng=key, train=False))(
                gen_vars, *args)
            warmup, _, init_state = jax_make_steps(cfg, model, disc)
            state, metrics = warmup.for_epoch(1)(
                init_state(jax.tree_util.tree_map(jnp.asarray, gen_vars),
                           jax.tree_util.tree_map(jnp.asarray, dis_vars)),
                jb, jax.random.PRNGKey(STEP_KEY))
            gen_mu = _numpy(state.gen_opt_state.inner_states["train"].inner_state[0].mu)
            gen_mu.pop("llm")
            runs[variant] = dict(
                cfg=cfg, batch=batch, gen=gen_vars, dis=dis_vars,
                forward=[np.asarray(x) for x in forward],
                eps=np.asarray(jax.random.normal(key, (B, cfg.hop.z_size))),
                metrics={k: float(v) for k, v in metrics.items()},
                gen_grads=jax.tree_util.tree_map(lambda m: 2.0 * m, gen_mu),
                new_gen={"params": _numpy(state.gen_params),
                         "batch_stats": _numpy(state.gen_stats)})
    return runs


def _port_model(run, variant):
    cfg = _cfg(tcfg, variant)
    model = HOPModel(cfg, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(run["gen"], cfg), strict=True)
    model.llm_model.dropout_rate = 0.0
    if cfg.hop.use_reprogramming:
        model.reprogramming_layer.attention_dropout = 0.0
    return cfg, model


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=path)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_converters_round_trip(jax_runs, variant):
    run = jax_runs[variant]
    cfg, model = _port_model(run, variant)
    names = set(model.state_dict())
    assert ("gwnet.start_conv.weight" in names) == cfg.hop.use_gwnet
    assert ("audio_encoder.feat_extractor.0.weight" in names) != cfg.hop.use_gwnet
    assert ("align_layer.weight" in names) == cfg.hop.use_reprogramming
    assert model.gru.weight_ih_l0.shape[1] == gru_input_size(cfg)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(run["gen"], cfg).items()
          if not k.endswith("num_batches_tracked")}
    _assert_trees_equal(convert_hop_model(sd, run["cfg"]), run["gen"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_forward_matches_jax(jax_runs, variant):
    run = jax_runs[variant]
    _, model = _port_model(run, variant)
    b = {k: torch.tensor(v) for k, v in run["batch"].items()}
    with torch.no_grad():
        got = model(b["in_audio"], b["log_mel"], b["text_padded"], b["target_vec"][:, :16],
                    b["vid_indices"], eps=torch.tensor(run["eps"]))
    for g, w, name in zip(got, run["forward"], ("out", "z", "mu", "logvar")):
        torch.testing.assert_close(g, torch.tensor(w), rtol=0,
                                   atol=1e-5 * np.abs(w).max(), msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_warmup_step_matches_jax(jax_runs, variant):
    run = jax_runs[variant]
    cfg, model = _port_model(run, variant)
    disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(discriminator_state_dict_from_jax(run["dis"]), strict=True)
    warmup, _, init_state = make_hop_train_steps(cfg, model, disc)
    tb = {k: torch.tensor(v) for k, v in run["batch"].items()}
    _, metrics = warmup.for_epoch(1)(init_state(), tb, jax_noise(cfg, run["batch"]))
    _check_metrics(metrics, run["metrics"])

    def to_sd(v):
        return state_dict_from_jax(v, cfg)
    _check_net(model, to_sd, run["gen"], run["gen_grads"], run["new_gen"],
               cfg.train.learning_rate, "generator")
    assert not _grads(disc)
