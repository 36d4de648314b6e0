"""The port's fused HOP train step (hop_tpu_torch.train.llm) against
hop_tpu.train.llm's, one step from identical converted state, at
tiny_test_config("TED") with B=4: the warmup step and the GAN step, each
in its epoch-0 and its steady variant.

Dropout is off on both sides: flax's `Dropout.__call__` is the identity
for the JAX steps (monkeypatched here; no file of hop_tpu changes) and
every dropout rate of the port's modules is 0. The JAX side runs its
plain paths (the einsum reprogramming attention and the scan GRU, its
default on the CPU) in f32 (conftest.py), the port its plain kernel
versions; BERT's bf16 matmuls are off on both. JAX's random draws of a
fused step (train/llm.py:213, :197-200, models/hop.py:116-118,
models/common.py:27-32, train/llm.py:166-169) are reproduced here from the
step key and handed to the port as its `StepNoise`.

JAX does not return its gradients, but Adam's first step leaves
mu = (1 - b1) g = g / 2 in its state, exactly (b1 = 0.5); the port's
torch Adam holds the same, and `p.grad` besides. Tolerances (f32 through
~20 layers and a backward):
  * losses and metrics: 2e-5 relative;
  * each gradient tensor: 1e-4 of its largest element. A tensor whose
    gradient stays below 1e-5 of its net's largest is round-off of an
    exactly zero gradient (a bias that a following BatchNorm, or the
    softmax over the prototypes, cancels): both sides must stay below that;
  * BatchNorm running statistics: 1e-5;
  * updated parameters: Adam's first step moves a parameter by
    lr * g / (|g| + 1e-8), so where |g| is resolved (above ten gradient
    tolerances and 1e-5) the two agree to lr * 1e-3; where it is not, the
    step's sign is round-off on both sides and only |step| <= lr holds.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.train.llm import make_hop_train_steps as jax_make_steps

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import (discriminator_state_dict_from_jax,
                                   state_dict_from_jax)
from hop_tpu_torch.data.synthetic import make_train_batch
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.train.llm import StepNoise, make_hop_train_steps

B = 4
N_SPEAKERS = 10
STEP_KEY = 7
LOSS_RTOL = 2e-5
GRAD_REL = 1e-4
ZERO_GRAD_REL = 1e-5
STATS_TOL = 1e-5
BATCH_KEYS = ("in_audio", "log_mel", "text_padded", "target_vec", "vid_indices")
VARIANTS = [("warmup", 0), ("warmup", 1), ("gan", 0), ("gan", 1)]


def _f32(cfg):
    return cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, flax_meta.unbox(tree))


def _no_dropout(self, inputs, *args, **kwargs):
    return inputs


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side: initial variables, the batch, and for each variant the
    metrics, gradients and new state after one step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOP_TPU_PALLAS_REPROG", raising=False)
        mp.delenv("HOP_TPU_PALLAS_GRU", raising=False)
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        cfg = _f32(jcfg.tiny_test_config("TED"))
        nb = jsynthetic.make_batch(cfg, B, seed=0)
        nb["text_padded"] = nb["text_padded"] % cfg.llm.vocab_size
        nb = jsynthetic.add_device_features(nb, cfg)
        batch = {k: np.asarray(nb[k]) for k in BATCH_KEYS}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        model, disc = JaxHOP(cfg, n_speakers=N_SPEAKERS), JaxDisc()
        gen_vars = jax.jit(lambda key: model.init(
            {"params": key, "dropout": key}, jb["in_audio"], jb["log_mel"],
            jb["text_padded"], jb["target_vec"][:, :16], jb["vid_indices"],
            rng=key, train=True))(jax.random.PRNGKey(0))
        dis_vars = jax.jit(lambda key: disc.init(
            {"params": key, "dropout": key}, jb["target_vec"], train=True))(
            jax.random.PRNGKey(2))
        init = {"gen": _numpy(gen_vars), "dis": _numpy(dis_vars)}
        # BN statistics away from (0, 1), so that their update shows
        r = np.random.default_rng(3)
        for stats in (init["gen"]["batch_stats"]["gwnet"],
                      init["dis"]["batch_stats"]):
            for bn in jax.tree_util.tree_leaves(
                    stats, is_leaf=lambda t: isinstance(t, dict) and "mean" in t):
                bn["mean"] = r.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
                bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)

        warmup, gan, init_state = jax_make_steps(cfg, model, disc)
        runs = {}
        for kind, epoch in VARIANTS:
            step = (warmup if kind == "warmup" else gan).for_epoch(epoch)
            gen = jax.tree_util.tree_map(jnp.asarray, {**gen_vars, "batch_stats":
                                                       init["gen"]["batch_stats"]})
            dis = jax.tree_util.tree_map(jnp.asarray, {**dis_vars, "batch_stats":
                                                       init["dis"]["batch_stats"]})
            state, metrics = step(init_state(gen, dis), jb,
                                  jax.random.PRNGKey(STEP_KEY))
            gen_mu = _numpy(state.gen_opt_state.inner_states["train"]
                            .inner_state[0].mu)
            gen_mu.pop("llm")
            runs[(kind, epoch)] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                gen_grads={k: jax.tree_util.tree_map(lambda m: 2.0 * m, v)
                           for k, v in gen_mu.items()},
                dis_grads=jax.tree_util.tree_map(
                    lambda m: 2.0 * m, _numpy(state.dis_opt_state[0].mu)),
                gen={"params": _numpy(state.gen_params),
                     "batch_stats": _numpy(state.gen_stats)},
                dis={"params": _numpy(state.dis_params),
                     "batch_stats": _numpy(state.dis_stats)})
    return cfg, batch, init, runs


def jax_noise(cfg, batch):
    """The draws of hop_tpu's fused step for key STEP_KEY, as a StepNoise."""
    rng_fwd, _, rng_d = jax.random.split(jax.random.PRNGKey(STEP_KEY), 3)
    rng_z, _ = jax.random.split(rng_fwd)                    # llm.py:197
    rng_perm, rng_z = jax.random.split(rng_z)               # llm.py:198
    perm = np.asarray(jax.random.permutation(rng_perm, B))  # llm.py:200
    np.testing.assert_array_equal(
        batch["vid_indices"][perm],
        np.asarray(jax.random.permutation(rng_perm, jnp.asarray(batch["vid_indices"]))))
    rng_a, rng_b = jax.random.split(rng_z)                  # hop.py:116
    z = cfg.hop.z_size
    rng_nt, rng_nf, _, _ = jax.random.split(rng_d, 4)       # llm.py:166
    shape = batch["target_vec"].shape
    t = lambda a: torch.tensor(np.asarray(a))
    return StepNoise(eps=t(jax.random.normal(rng_a, (B, z))),
                     eps_rand=t(jax.random.normal(rng_b, (B, z))),
                     perm=t(perm).long(),
                     target_noise=t(jax.random.normal(rng_nt, shape)),
                     fake_noise=t(jax.random.normal(rng_nf, shape)),
                     reprog_seed=0, dropout_seed=0)


def _port(cfg_j, init, loss=None):
    cfg = _f32(tcfg.tiny_test_config("TED"))
    if loss is not None:
        cfg = cfg.replace(loss=loss)
    model = HOPModel(cfg, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(init["gen"], cfg), strict=True)
    disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(discriminator_state_dict_from_jax(init["dis"]), strict=True)
    model.llm_model.dropout_rate = 0.0
    model.reprogramming_layer.attention_dropout = 0.0
    disc.gru.dropout = 0.0
    return cfg, model, disc


def _port_step(cfg_j, batch, init, kind, epoch, loss=None):
    cfg, model, disc = _port(cfg_j, init, loss)
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    state = init_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = (warmup if kind == "warmup" else gan).for_epoch(epoch)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    state, metrics = step(state, tb, jax_noise(cfg_j, batch))
    return cfg, model, disc, before, metrics


def _grads(module):
    return {k: p.grad for k, p in module.named_parameters()
            if p.requires_grad and p.grad is not None}


def _grad_tols(want_sd, names):
    """Per tensor: the gradient tolerance, or None for an exactly zero
    gradient, whose round-off must stay below `zero` (see the docstring)."""
    zero = ZERO_GRAD_REL * max(want_sd[k].abs().max().item() for k in names)
    tols = {}
    for k in names:
        top = want_sd[k].abs().max().item()
        tols[k] = None if top < zero else GRAD_REL * top
    return tols, zero


def _assert_grads(got, want_sd, name):
    assert got, name
    tols, zero = _grad_tols(want_sd, got)
    for k, g in got.items():
        if tols[k] is None:
            assert g.abs().max().item() < zero, f"{name} {k}: not ~0"
        else:
            torch.testing.assert_close(g, want_sd[k], rtol=0, atol=tols[k],
                                       msg=f"{name} {k}")
    return tols


def _assert_params(module, want_sd, grads_sd, tols, lr):
    for k, v in module.state_dict().items():
        w = want_sd[k]
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, w, rtol=0, atol=STATS_TOL, msg=k)
            continue
        resolved = torch.zeros_like(v, dtype=torch.bool)
        if tols.get(k) is not None:
            resolved = grads_sd[k].abs() > max(10 * tols[k], 1e-5)
        torch.testing.assert_close(v[resolved], w[resolved], rtol=0,
                                   atol=lr * 1e-3, msg=k)
        assert (v - w).abs().masked_fill(resolved, 0).max().item() <= 2 * lr, k


@pytest.mark.parametrize("kind,epoch", VARIANTS)
def test_step_matches_jax(jax_runs, kind, epoch):
    cfg_j, batch, init, runs = jax_runs
    want = runs[(kind, epoch)]
    cfg, model, disc, before, metrics = _port_step(cfg_j, batch, init, kind, epoch)

    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)

    # gradients: JAX's in the port's names and layouts
    gen_grads = {**init["gen"]["params"], **want["gen_grads"]}
    want_g = state_dict_from_jax({"params": gen_grads,
                                  "batch_stats": init["gen"]["batch_stats"]}, cfg)
    g_tols = _assert_grads(_grads(model), want_g, "generator")
    d_grads = _grads(disc)
    d_tols, want_d = {}, None
    if kind == "gan":
        want_d = discriminator_state_dict_from_jax(
            {"params": want["dis_grads"], "batch_stats": init["dis"]["batch_stats"]})
        d_tols = _assert_grads(d_grads, want_d, "discriminator")
        assert len(d_grads) == len(list(disc.parameters()))
    else:
        assert not d_grads

    # updated parameters and BatchNorm statistics
    lr = cfg.train.learning_rate
    _assert_params(model, state_dict_from_jax(want["gen"], cfg), want_g, g_tols, lr)
    _assert_params(disc, discriminator_state_dict_from_jax(want["dis"]), want_d,
                   d_tols, lr * cfg.train.dis_lr_scale)

    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("llm_model."):
            assert torch.equal(after[k], v), f"frozen {k} changed"
    for k in ("align_layer.weight", "mapping_layer.weight"):
        assert not torch.equal(after[k], before[k]), f"{k} did not move"


def test_no_generator_term_gradient_in_discriminator(jax_runs):
    """The G term sees the discriminator frozen: its weight does not change
    the discriminator's gradients."""
    cfg_j, batch, init, _ = jax_runs
    grads = []
    for gan_weight in (5.0, 0.0):
        loss = dataclasses.replace(tcfg.ted_config().loss, gan_weight=gan_weight)
        _, _, disc, _, _ = _port_step(cfg_j, batch, init, "gan", 1, loss)
        grads.append(_grads(disc))
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_make_train_batch_fields():
    cfg = tcfg.tiny_test_config("TED")
    batch = make_train_batch(cfg, 3, seed=1, n_speakers=N_SPEAKERS)
    d = cfg.data
    want = {"in_audio": (3, d.expected_audio_length),
            "log_mel": (3, d.n_poses, d.mel_bins),
            "text_padded": (3, d.n_poses),
            "target_vec": (3, d.n_poses, d.pose_dim),
            "vid_indices": (3,)}
    assert {k: tuple(v.shape) for k, v in batch.items()} == want
    assert all(torch.isfinite(v.float()).all() for v in batch.values())
    assert int(batch["text_padded"].max()) < cfg.llm.vocab_size
    assert int(batch["vid_indices"].max()) < N_SPEAKERS
