"""One train step of each baseline family in the port against hop_tpu's, from
identical converted state, at tiny_test_config (hidden 32, 2 layers), B=4,
inputs from a numpy seed: here the trimodal GAN's warmup and GAN step
(hop_tpu.train.gan) on both GRU routes and seq2seq (train.seq2seq);
speech2gesture (train.speech2gesture) in test_torch_zoo_steps_s2g.py, and
joint_embedding and gesture_autoencoder on TED (train.embed's EmbeddingNet
step) and gesture_autoencoder on Expressive (the MotionAE step) in
test_torch_zoo_steps_embed.py, which share this file's helpers (the three
files split the JAX steps' compile time between the test workers).

Dropout is off on both sides (flax's Dropout is the identity here, every
dropout rate of the port's nets 0); JAX's draws of the GAN steps (the
speaker noise of each generator forward, the permutation;
hop_tpu/train/gan.py:51-67, :118-128) are handed to the port as its
`StepNoise`. JAX's gradients are read from Adam's first moment after
one step (mu = g / 2 at b1 = 0.5; for seq2seq after the global-norm clip,
as the port's `p.grad` is).

Tolerances, those of tests/test_torch_train_step.py (its helpers): losses
2e-5 relative; each gradient tensor 1e-4 of its largest element (a tensor
below 1e-5 of its net's largest is round-off of an exactly zero gradient,
on both sides); BatchNorm running statistics 1e-5; updated parameters
lr * 1e-3 where the gradient is resolved, else a step of at most 2 lr.
One exception to the zero rule: the WavEncoder's first convolution sums
B * 7891 positions into its bias's gradient, which the BatchNorm after it
makes exactly zero; that sum's round-off (5.0e-4 in the port, 5.0e-5 in
JAX, against 38 for the net's largest gradient, at this seed) outgrows the
zero rule's 1e-5 of the net's largest, so both sides are held to 1e-4 of
it there (`ROUND_OFF_SUMS`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from hop_tpu.config import tiny_test_config as jax_tiny
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.models.multimodal_context import PoseGenerator as JaxPoseGenerator
from hop_tpu.models.seq2seq import Seq2SeqNet as JaxSeq2Seq
from hop_tpu.train.gan import make_gan_train_steps as jax_gan_steps
from hop_tpu.train.seq2seq import make_seq2seq_train_step as jax_seq2seq_step

from hop_tpu_torch import convert
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator, PoseGenerator
from hop_tpu_torch.models.seq2seq import Seq2SeqNet
from hop_tpu_torch.train.gan import make_gan_train_steps
from hop_tpu_torch.train.llm import StepNoise
from hop_tpu_torch.train.seq2seq import make_seq2seq_train_step

from test_torch_train_step import (GRAD_REL, LOSS_RTOL, STATS_TOL, _assert_grads,  # noqa: F401
                                   _assert_params, _grads, _no_dropout, _numpy, _perm,
                                   one_torch_thread)

B = 4
N_WORDS = 50
N_SPEAKERS = 10
STEP_KEY = 11
# exactly zero gradients summed over the most terms (see the docstring)
ROUND_OFF_SUMS = ("audio_encoder.feat_extractor.0.bias",)


def _batch(dataset):
    cfg = jax_tiny(dataset)
    b = jsynthetic.add_device_features(jsynthetic.make_batch(cfg, B, seed=0), cfg)
    b = {k: np.asarray(v) for k, v in b.items() if not isinstance(v, dict)}
    b["text_padded"] = b["text_padded"] % N_WORDS
    b["word_seq"] = b["word_seq"] % N_WORDS
    b["vid_indices"] = b["vid_indices"] % N_SPEAKERS
    b["text_mask"] = (np.arange(b["word_seq"].shape[1])[None]
                      < b["text_lengths"][:, None]).astype(np.float32)
    return cfg, b



@pytest.fixture(scope="module")
def no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOP_TPU_PALLAS_GRU", raising=False)
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        yield


def _init(module, *args, seed=0, **kw):
    """Variables (numpy leaves) under jit, BatchNorm statistics away from (0, 1)."""
    variables = _numpy(jax.jit(lambda k, *a: module.init(
        {"params": k, "dropout": k}, *a, train=True, **kw))(jax.random.PRNGKey(seed),
                                                             *args))
    r = np.random.default_rng(seed + 3)
    for bn in jax.tree_util.tree_leaves(
            variables.get("batch_stats", {}),
            is_leaf=lambda t: isinstance(t, dict) and "mean" in t):
        bn["mean"] = r.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return variables


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(dtype), tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _mu(opt_state):
    """Adam's first moment in an optax state (a chain's, at any depth)."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for sub in opt_state:
        if isinstance(sub, tuple) or hasattr(sub, "mu"):
            found = _mu(sub)
            if found is not None:
                return found
    return None


def _grads_of(opt_state):
    return jax.tree_util.tree_map(lambda m: 2.0 * np.asarray(m), _numpy(_mu(opt_state)))


def _tb(batch, keys):
    return {k: torch.tensor(batch[k]) for k in keys}


def _no_port_dropout(*modules):
    for module in modules:
        for m in module.modules():
            for attr in ("dropout", "emb_dropout"):
                if isinstance(getattr(m, attr, None), float):
                    setattr(m, attr, 0.0)


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


def _check_net(module, to_sd, init, want_grads, want_state, lr, name,
               stats_tol=STATS_TOL):
    """The port's gradients and updated state against JAX's, in the port's
    names (`to_sd`: a converter of a {"params", "batch_stats"} tree)."""
    stats = init.get("batch_stats", {})
    want_g = to_sd({"params": {**init["params"], **want_grads}, "batch_stats": stats})
    got = _grads(module)
    largest = max(want_g[k].abs().max().item() for k in got)
    for k in ROUND_OFF_SUMS:
        if k in got:
            g = got.pop(k)
            assert max(g.abs().max().item(),
                       want_g[k].abs().max().item()) < GRAD_REL * largest, k
    tols = _assert_grads(got, want_g, name)
    _assert_params(module, to_sd(want_state), want_g, tols, lr, stats_tol)


# ---- the trimodal GAN ------------------------------------------------------

GAN_KEYS = ("in_audio", "text_padded", "target_vec", "vid_indices")


@pytest.fixture(scope="module")
def gan_runs(no_dropout):
    cfg, batch = _batch("TED")
    gen = JaxPoseGenerator(pose_dim=27, n_words=N_WORDS, n_speakers=N_SPEAKERS,
                           hidden_size=cfg.baseline.hidden_size,
                           n_layers=cfg.baseline.n_layers)
    disc = JaxDisc()
    pre = np.zeros((B, 34, 28), np.float32)
    init = {"gen": _init(gen, pre, batch["text_padded"], batch["in_audio"],
                         batch["vid_indices"], rng=jax.random.PRNGKey(1)),
            "dis": _init(disc, batch["target_vec"], seed=2)}
    jb = {k: jnp.asarray(batch[k]) for k in GAN_KEYS}
    runs = {}
    for kind in ("warmup", "gan"):
        warmup, gan, init_state = jax_gan_steps(cfg, gen, disc)
        state, metrics = (warmup if kind == "warmup" else gan)(
            init_state(_jnp(init["gen"]), _jnp(init["dis"])), jb,
            jax.random.PRNGKey(STEP_KEY))
        runs[kind] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            gen_grads=_grads_of(state.gen_opt_state),
            dis_grads=_grads_of(state.dis_opt_state),
            gen={"params": _numpy(state.gen_params), "batch_stats": _numpy(state.gen_stats)},
            dis={"params": _numpy(state.dis_params), "batch_stats": _numpy(state.dis_stats)})
    return cfg, batch, init, runs


def jax_gan_noise(batch, kind):
    """The draws of hop_tpu's trimodal step for key STEP_KEY: a generator
    forward's speaker noise is normal(first half of its key) (gan.py:51-56,
    common.py:27-32)."""
    def eps_of(rng):
        return torch.tensor(np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                                         (B, 16))))
    rng_g = jax.random.PRNGKey(STEP_KEY)
    eps_dis = torch.zeros(B, 16)                            # unused by the warmup
    if kind == "gan":
        rng_fwd, _, rng_g = jax.random.split(rng_g, 3)      # gan.py:118
        eps_dis = eps_of(rng_fwd)
    rng_fwd, rng_perm, rng_rand, _ = jax.random.split(rng_g, 4)   # gan.py:67
    return StepNoise(eps=eps_of(rng_fwd), eps_rand=eps_of(rng_rand),
                     perm=torch.tensor(_perm(rng_perm, batch)).long(),
                     eps_dis=eps_dis, dropout_seed=0)


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
@pytest.mark.parametrize("kind", ["warmup", "gan"])
def test_gan_step_matches_jax(gan_runs, kind, gru_kernel):
    cfg_j, batch, init, runs = gan_runs
    want = runs[kind]
    cfg = tiny_test_config("TED")
    gen = PoseGenerator(27, N_WORDS, N_SPEAKERS, cfg.baseline.hidden_size,
                        cfg.baseline.n_layers, gru_kernel=gru_kernel)
    gen.load_state_dict(convert.pose_generator_state_dict_from_jax(init["gen"]),
                        strict=True)
    disc = ConvDiscriminator(27, 34, gru_kernel=gru_kernel)
    disc.load_state_dict(convert.discriminator_state_dict_from_jax(init["dis"]),
                         strict=True)
    _no_port_dropout(gen, disc)
    warmup, gan, init_state = make_gan_train_steps(cfg, gen, disc)
    _, metrics = (warmup if kind == "warmup" else gan)(
        init_state(), _tb(batch, GAN_KEYS), jax_gan_noise(batch, kind))
    _check_metrics(metrics, want["metrics"])
    lr = cfg.train.learning_rate
    _check_net(gen, convert.pose_generator_state_dict_from_jax, init["gen"],
               want["gen_grads"], want["gen"], lr, "generator")
    if kind == "gan":
        # the G term's forward runs on the UPDATED discriminator, whose conv
        # biases in front of its BatchNorms moved by a round-off-signed lr_D
        # (exactly zero gradients): its running means may differ by 0.1 * 2 *
        # lr_D on top of STATS_TOL (test_torch_train_step.py's 3-forward rule)
        lr_d = lr * cfg.train.dis_lr_scale
        _check_net(disc, convert.discriminator_state_dict_from_jax, init["dis"],
                   want["dis_grads"], want["dis"], lr_d, "discriminator",
                   STATS_TOL + 0.1 * 2 * lr_d)
    else:
        assert not _grads(disc)
        for k, v in disc.state_dict().items():
            assert torch.equal(v, convert.discriminator_state_dict_from_jax(init["dis"])[k])


# ---- seq2seq, speech2gesture, the embedding nets ---------------------------

def _one_net_run(step_fn, variables, batch, keys):
    state, metrics = step_fn[0](step_fn[1](_jnp(variables)),
                                {k: jnp.asarray(batch[k]) for k in keys},
                                jax.random.PRNGKey(STEP_KEY))
    new = {"params": _numpy(state.params)}
    if state.stats:
        new["batch_stats"] = _numpy(state.stats)
    return {k: float(v) for k, v in metrics.items()}, _grads_of(state.opt_state), new


def test_seq2seq_step_matches_jax(no_dropout):
    cfg_j, batch = _batch("TED")
    b = cfg_j.baseline
    keys = ("word_seq", "text_mask", "target_vec")
    net = JaxSeq2Seq(pose_dim=27, n_frames=34, n_pre_poses=4, n_words=N_WORDS,
                     embed_size=300, hidden_size=b.hidden_size, n_layers=b.n_layers)
    variables = _init(net, *(batch[k] for k in keys))
    want_m, want_g, want = _one_net_run(jax_seq2seq_step(cfg_j, net), variables, batch,
                                        keys)
    cfg = tiny_test_config("TED")
    port = Seq2SeqNet(27, 34, 4, N_WORDS, 300, b.hidden_size, b.n_layers)
    port.load_state_dict(convert.seq2seq_state_dict_from_jax(variables), strict=True)
    _no_port_dropout(port)
    step, init_state = make_seq2seq_train_step(cfg, port)
    _, metrics = step(init_state(), _tb(batch, keys), 0)
    _check_metrics(metrics, want_m)
    _check_net(port, convert.seq2seq_state_dict_from_jax, variables, want_g, want,
               cfg.train.learning_rate, "seq2seq")
