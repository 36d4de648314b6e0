"""HOP on TED Expressive (pose_dim 126, gwnet on 42 nodes, the head's first
GRU layer 1751 wide at full width) in the port against hop_tpu.train.llm,
one step from identical converted state at tiny_test_config(
"TED_expressive"), B = 4, inputs from a numpy seed: the fused warmup and
GAN steps, each in its epoch-0 and steady variant, and the reference's
3-forward GAN step (`fused_step=False`); the epoch-0 GAN steps are in
test_torch_expressive_step_gan.py, on this file's helpers (each file
compiles hop_tpu's steps for about a minute). Dropout off on both sides, JAX's
draws handed in as the port's `StepNoise`; tests/test_torch_train_step.py's
helpers and tolerances, unchanged (its docstring): losses 2e-5 relative,
each gradient tensor 1e-4 of its largest element, BatchNorm statistics
1e-5 (plus 0.1 * 2 lr_D in the 3-forward GAN step), updated parameters
lr * 1e-3 where the gradient is resolved. The state starts from the port's
seeded init (BatchNorm statistics moved away from (0, 1)), carried to
hop_tpu through its own importers (`convert_hop_model`,
`convert_conv_discriminator`): flax's init compiles for about as long as a
step."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.eval.torch_import_generator import convert_conv_discriminator
from hop_tpu.eval.torch_import_hop import convert_hop_model
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.train.llm import make_hop_train_steps as jax_make_steps

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from hop_tpu_torch.models.hop import HOPModel, gru_input_size
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.train.llm import make_hop_train_steps

from test_torch_train_step import (B, BATCH_KEYS, LOSS_RTOL, N_SPEAKERS, STATS_TOL, STEP_KEY,
                                   _assert_grads, _assert_params, _f32, _grads, _no_dropout,
                                   _numpy, jax_noise, jax_parity_noise)
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

DATASET = "TED_expressive"
# (kind, epoch, fused)
STEPS = [("warmup", 0, True), ("warmup", 1, True), ("gan", 1, True)]


def initial_variables(cfg_j, cfg):
    """The port's HOPModel and ConvDiscriminator at `cfg` from seed 0, their
    BatchNorm statistics moved away from (0, 1), as hop_tpu's variables
    (config `cfg_j`) through its importers."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = HOPModel(cfg, n_speakers=N_SPEAKERS)
        disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    r = np.random.default_rng(3)
    for m in (*model.modules(), *disc.modules()):
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(torch.tensor(r.normal(0, 0.3, m.num_features)))
            m.running_var.copy_(torch.tensor(r.uniform(0.5, 1.5, m.num_features)))

    def numpy_sd(net):
        return {k: v.detach().numpy() for k, v in net.state_dict().items()
                if not k.endswith("num_batches_tracked")}
    return convert_hop_model(numpy_sd(model), cfg_j), convert_conv_discriminator(numpy_sd(disc))


def expressive_runs(steps):
    """hop_tpu's side: the config, the batch, the initial variables and,
    for each of `steps`, the metrics, gradients and new state."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOP_TPU_PALLAS_REPROG", raising=False)
        mp.delenv("HOP_TPU_PALLAS_GRU", raising=False)
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        cfg = _f32(jcfg.tiny_test_config(DATASET))
        nb = jsynthetic.make_batch(cfg, B, seed=0)
        nb["text_padded"] = nb["text_padded"] % cfg.llm.vocab_size
        nb = jsynthetic.add_device_features(nb, cfg)
        batch = {k: np.asarray(nb[k]) for k in BATCH_KEYS}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        model, disc = JaxHOP(cfg, n_speakers=N_SPEAKERS), JaxDisc()
        gen_vars, dis_vars = initial_variables(cfg, _f32(tcfg.tiny_test_config(DATASET)))
        runs = {}
        for kind, epoch, fused in steps:
            step_cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, fused_step=fused))
            warmup, gan, init_state = jax_make_steps(step_cfg, model, disc)
            step = (warmup if kind == "warmup" else gan).for_epoch(epoch)
            state, metrics = step(init_state(jax.tree_util.tree_map(jnp.asarray, gen_vars),
                                             jax.tree_util.tree_map(jnp.asarray, dis_vars)),
                                  jb, jax.random.PRNGKey(STEP_KEY))
            gen_mu = _numpy(state.gen_opt_state.inner_states["train"].inner_state[0].mu)
            gen_mu.pop("llm")
            runs[(kind, epoch, fused)] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                gen_grads={k: jax.tree_util.tree_map(lambda m: 2.0 * m, v)
                           for k, v in gen_mu.items()},
                dis_grads=jax.tree_util.tree_map(lambda m: 2.0 * m,
                                                 _numpy(state.dis_opt_state[0].mu)),
                gen={"params": _numpy(state.gen_params),
                     "batch_stats": _numpy(state.gen_stats)},
                dis={"params": _numpy(state.dis_params),
                     "batch_stats": _numpy(state.dis_stats)})
    return cfg, batch, {"gen": gen_vars, "dis": dis_vars}, runs


@pytest.fixture(scope="module")
def jax_runs():
    return expressive_runs(STEPS)


def step_ids(steps):
    return [f"{k}-{e}-{'fused' if f else '3-forward'}" for k, e, f in steps]


@pytest.mark.parametrize("kind,epoch,fused", STEPS, ids=step_ids(STEPS))
def test_expressive_step_matches_jax(jax_runs, kind, epoch, fused):
    check_step(jax_runs, kind, epoch, fused)


def check_step(jax_runs, kind, epoch, fused):
    cfg_j, batch, init, runs = jax_runs
    want = runs[(kind, epoch, fused)]
    cfg = _f32(tcfg.tiny_test_config(DATASET))
    cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, fused_step=fused))
    assert cfg.data.pose_dim == 126 and cfg.data.n_joints_graph == 42
    assert gru_input_size(tcfg.expressive_config()) == 1751
    model = HOPModel(cfg, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(init["gen"], cfg), strict=True)
    disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(discriminator_state_dict_from_jax(init["dis"]), strict=True)
    model.llm_model.dropout_rate = 0.0
    model.reprogramming_layer.attention_dropout = 0.0
    disc.gru.dropout = 0.0
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    noise = (jax_noise(cfg_j, batch) if fused else jax_parity_noise(cfg_j, batch, kind))
    _, metrics = (warmup if kind == "warmup" else gan).for_epoch(epoch)(
        init_state(), {k: torch.tensor(v) for k, v in batch.items()}, noise)

    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    want_g = state_dict_from_jax({"params": {**init["gen"]["params"], **want["gen_grads"]},
                                  "batch_stats": init["gen"]["batch_stats"]}, cfg)
    g_tols = _assert_grads(_grads(model), want_g, "generator")
    lr = cfg.train.learning_rate
    _assert_params(model, state_dict_from_jax(want["gen"], cfg), want_g, g_tols, lr)
    lr_d = lr * cfg.train.dis_lr_scale
    d_tols, want_d = {}, None
    if kind == "gan":
        want_d = discriminator_state_dict_from_jax(
            {"params": want["dis_grads"], "batch_stats": init["dis"]["batch_stats"]})
        d_tols = _assert_grads(_grads(disc), want_d, "discriminator")
    else:
        assert not _grads(disc)
    stats_tol = STATS_TOL + (0.1 * 2 * lr_d if kind == "gan" and not fused else 0.0)
    _assert_params(disc, discriminator_state_dict_from_jax(want["dis"]), want_d, d_tols,
                   lr_d, stats_tol)
