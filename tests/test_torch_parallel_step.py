"""The port's train steps on 2 ranks (hop_tpu_torch.parallel; gloo on the CPU,
one thread a rank) against hop_tpu's step sharded over `create_mesh(2, 1)`,
at tiny_test_config("TED"), global batch 8, from identical converted state:
the fused HOP warmup and GAN steps and the trimodal GAN's warmup step (the
model of tests/test_parallel.py:23-40).

Dropout is off on both sides, JAX's draws for the global batch are handed to
the ranks as a `StepNoise` (each rank takes its rows), and the tolerances are
tests/test_torch_train_step.py's, unchanged (its helpers): losses 2e-5
relative, each gradient 1e-4 of its largest element, BatchNorm running
statistics 1e-5, updated parameters lr * 1e-3 where the gradient is resolved.
The ranks hold the global batch's gradients (averaged over the batch group
before Adam), BatchNorm statistics and metrics, and end bit for bit equal.

ZeRO (each rank holding half of Adam's moments) against `--no-zero2`: the
parameters and the gathered optimizer states are bitwise equal. A planted
fault, BatchNorm on each rank's rows alone (set in the rank's process by
tests/torch_parallel_worker.py, not in the port), must fail the comparison.
"""

import concurrent.futures
import dataclasses
import os

import flax.linen as fnn
from flax.core import meta as flax_meta
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.models.multimodal_context import PoseGenerator as JaxPoseGenerator
from hop_tpu.parallel import create_mesh, shard_batch, shard_state
from hop_tpu.train.gan import make_gan_train_steps as jax_gan_steps
from hop_tpu.train.llm import make_hop_train_steps as jax_hop_steps

from hop_tpu_torch import config as tcfg
from hop_tpu_torch import convert
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator, PoseGenerator
from hop_tpu_torch.parallel.local import check_ranks, run_ranks
from hop_tpu_torch.utils.checkpoint import differing_entries

from test_torch_train_step import (LOSS_RTOL, STATS_TOL, _assert_grads, _assert_params,
                                   _grads, _no_dropout, _numpy,
                                   one_torch_thread)  # noqa: F401 (a fixture)
from test_torch_zoo_steps import _check_net, _jnp, _grads_of

B = 8
N_SPEAKERS = 10
N_WORDS = 50
STEP_KEY = 7
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
HOP_KEYS = ("in_audio", "log_mel", "text_padded", "target_vec", "vid_indices")
MM_KEYS = ("in_audio", "text_padded", "target_vec", "vid_indices")
CASES = [{"name": "hop_warmup", "family": "hop", "kind": "warmup", "epoch": 1},
         {"name": "hop_gan", "family": "hop", "kind": "gan", "epoch": 1},
         {"name": "mm_warmup", "family": "mm", "kind": "warmup"}]
RANK_SECONDS = 240


def _t(a):
    return torch.tensor(np.asarray(a))


def _perm(rng_perm, vids):
    perm = np.asarray(jax.random.permutation(rng_perm, B))
    np.testing.assert_array_equal(
        vids[perm], np.asarray(jax.random.permutation(rng_perm, jnp.asarray(vids))))
    return perm


def hop_noise(cfg, batch):
    """hop_tpu's fused-step draws for STEP_KEY at batch B (train/llm.py:197-200,
    :166; models/hop.py:116), as StepNoise fields."""
    rng_fwd, _, rng_d = jax.random.split(jax.random.PRNGKey(STEP_KEY), 3)
    rng_z, _ = jax.random.split(rng_fwd)
    rng_perm, rng_z = jax.random.split(rng_z)
    rng_a, rng_b = jax.random.split(rng_z)
    rng_nt, rng_nf, _, _ = jax.random.split(rng_d, 4)
    z, shape = cfg.hop.z_size, batch["target_vec"].shape
    return dict(eps=_t(jax.random.normal(rng_a, (B, z))),
                eps_rand=_t(jax.random.normal(rng_b, (B, z))),
                perm=_t(_perm(rng_perm, batch["vid_indices"])).long(),
                target_noise=_t(jax.random.normal(rng_nt, shape)),
                fake_noise=_t(jax.random.normal(rng_nf, shape)),
                reprog_seed=0, dropout_seed=0)


def mm_noise(batch):
    """hop_tpu's trimodal warmup draws for STEP_KEY (gan.py:51-67)."""
    def eps_of(rng):
        return _t(jax.random.normal(jax.random.split(rng)[0], (B, 16)))
    rng_fwd, rng_perm, rng_rand, _ = jax.random.split(jax.random.PRNGKey(STEP_KEY), 4)
    return dict(eps=eps_of(rng_fwd), eps_rand=eps_of(rng_rand),
                perm=_t(_perm(rng_perm, batch["vid_indices"])).long(),
                eps_dis=torch.zeros(B, 16), dropout_seed=0)


def _init(module, *args, seed=0, **kw):
    """Variables of `module`'s shapes (traced, not compiled: a jitted init
    of the HOP model is the module's costliest compile after its steps),
    drawn from a numpy generator seeded
    `seed`: weights N(0, 1 / fan-in), biases N(0, 0.05), scales 1 + N(0,
    0.05), BatchNorm statistics as test_torch_zoo_steps._init draws them."""
    shapes = flax_meta.unbox(jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, train=True, **kw), jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "mean":
            return r.normal(0, 0.3, shape)
        if name == "var":
            return r.uniform(0.5, 1.5, shape)
        if name == "scale":
            return 1.0 + r.normal(0, 0.05, shape)
        if len(shape) < 2:
            return r.normal(0, 0.05, shape)
        return r.normal(0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: draw(path, leaf).astype(leaf.dtype), shapes)


def _hop_grads(opt_state):
    """The generator's gradients from Adam's first moment of its trainable
    part (test_torch_train_step.py's reading), without the frozen backbone."""
    mu = _numpy(opt_state.inner_states["train"].inner_state[0].mu)
    mu.pop("llm")
    return jax.tree_util.tree_map(lambda m: 2.0 * m, mu)


def _sharded_step(step, state, batch, hop):
    mesh = create_mesh(2, 1)
    with mesh:
        state = shard_state(state, mesh, zero2=True)
        state, metrics = step(state, shard_batch(batch, mesh), jax.random.PRNGKey(STEP_KEY))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                gen_grads=(_hop_grads if hop else _grads_of)(state.gen_opt_state),
                dis_grads=_grads_of(state.dis_opt_state),
                gen={"params": _numpy(state.gen_params), "batch_stats": _numpy(state.gen_stats)},
                dis={"params": _numpy(state.dis_params), "batch_stats": _numpy(state.dis_stats)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """hop_tpu's sharded steps, the spec of the ranks' runs, and the ranks'
    launch (one of 2 ranks: the cases with ZeRO and without, and the HOP GAN
    step with the planted fault), started as soon as the spec is written so
    that the ranks run while hop_tpu's steps compile."""
    directory = tmp_path_factory.mktemp("ranks")
    with pytest.MonkeyPatch.context() as mp:
        for var in ("HOP_TPU_PALLAS_REPROG", "HOP_TPU_PALLAS_GRU", "HOP_TPU_PALLAS_BLOCK_ATTN"):
            mp.delenv(var, raising=False)
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        cfg = jcfg.tiny_test_config("TED")
        cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False))
        nb = jsynthetic.add_device_features(jsynthetic.make_batch(cfg, B, seed=0), cfg)
        nb = {k: np.asarray(v) for k, v in nb.items() if not isinstance(v, dict)}
        hop_batch = dict(nb, text_padded=nb["text_padded"] % cfg.llm.vocab_size)
        hop_batch = {k: hop_batch[k] for k in HOP_KEYS}
        mm_batch = dict(nb, text_padded=nb["text_padded"] % N_WORDS,
                        vid_indices=nb["vid_indices"] % N_SPEAKERS)
        mm_batch = {k: mm_batch[k] for k in MM_KEYS}

        model, disc = JaxHOP(cfg, n_speakers=N_SPEAKERS), JaxDisc()
        jb = {k: jnp.asarray(v) for k, v in hop_batch.items()}
        hop_init = {"gen": _init(model, jb["in_audio"], jb["log_mel"], jb["text_padded"],
                                 jb["target_vec"][:, :16], jb["vid_indices"],
                                 rng=jax.random.PRNGKey(0)),
                    "dis": _init(disc, jb["target_vec"], seed=2)}
        gen = JaxPoseGenerator(pose_dim=27, n_words=N_WORDS, n_speakers=N_SPEAKERS,
                               hidden_size=cfg.baseline.hidden_size,
                               n_layers=cfg.baseline.n_layers)
        mm_init = {"gen": _init(gen, np.zeros((B, 34, 28), np.float32), mm_batch["text_padded"],
                                mm_batch["in_audio"], mm_batch["vid_indices"],
                                rng=jax.random.PRNGKey(1)),
                   "dis": hop_init["dis"]}

        port_cfg = tcfg.tiny_test_config("TED")
        spec = {"job": "step", "cases": CASES,
                "hop": {"gen": convert.state_dict_from_jax(hop_init["gen"], port_cfg),
                        "dis": convert.discriminator_state_dict_from_jax(hop_init["dis"]),
                        "n_speakers": N_SPEAKERS, "batch": hop_batch,
                        "noise": {"warmup": hop_noise(cfg, hop_batch),
                                  "gan": hop_noise(cfg, hop_batch)}},
                "mm": {"gen": convert.pose_generator_state_dict_from_jax(mm_init["gen"]),
                       "dis": convert.discriminator_state_dict_from_jax(mm_init["dis"]),
                       "n_speakers": N_SPEAKERS, "n_words": N_WORDS, "batch": mm_batch,
                       "noise": {"warmup": mm_noise(mm_batch)}}}
        jobs = {"zero": dict(spec, zero2=True), "no_zero": dict(spec, zero2=False),
                "local_bn": dict(spec, fault="local_bn", cases=[CASES[1]])}
        pool = concurrent.futures.ThreadPoolExecutor(1)
        ranks = pool.submit(launch, {"data_parallel": 2, "jobs": jobs}, directory, "steps")
        pool.shutdown(wait=False)

        want = {}
        warmup, gan, init_state = jax_hop_steps(cfg, model, disc)
        for kind, step in (("warmup", warmup), ("gan", gan)):
            want["hop_" + kind] = _sharded_step(step.for_epoch(1), init_state(
                _jnp(hop_init["gen"]), _jnp(hop_init["dis"])), jb, hop=True)
        mb = {k: jnp.asarray(v) for k, v in mm_batch.items()}
        warmup, _, init_state = jax_gan_steps(cfg, gen, disc)
        want["mm_warmup"] = _sharded_step(warmup, init_state(_jnp(mm_init["gen"]),
                                                             _jnp(mm_init["dis"])), mb,
                                          hop=False)
    inits = {"hop": hop_init, "mm": mm_init}
    return want, inits, ranks


def launch(spec, directory, name, world=2):
    """Run the spec's jobs on `world` ranks; each rank's results. The spec and
    the ranks' result files are removed once read: the parallel files' state
    dicts would otherwise hold ~2 GB of the test run's temporary disk to its
    end."""
    spec = dict(spec, out=str(directory / name))
    path = directory / f"{name}.spec.pt"
    outs = [directory / f"{name}.{r}.pt" for r in range(world)]
    torch.save(spec, path)
    try:
        check_ranks(run_ranks([WORKER, str(path)], world, RANK_SECONDS))
        return [torch.load(out, weights_only=False) for out in outs]
    finally:
        for f in (path, *outs):
            f.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[2].result()


def _with(module, state, grads):
    """`module` holding a rank's state and gradients (for the helpers)."""
    module.load_state_dict(state, strict=True)
    for k, p in module.named_parameters():
        p.grad = grads.get(k)
    return module


def check_hop(got, want, init, kind):
    cfg = tcfg.tiny_test_config("TED")
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    model = _with(HOPModel(cfg, N_SPEAKERS), got["gen"], got["gen_grads"])
    disc = _with(ConvDiscriminator(27, 34), got["dis"], got["dis_grads"])
    want_g = convert.state_dict_from_jax(
        {"params": {**init["gen"]["params"], **want["gen_grads"]},
         "batch_stats": init["gen"]["batch_stats"]}, cfg)
    want_g = {k: v for k, v in want_g.items() if not k.startswith("llm_model.")}
    g_tols = _assert_grads(_grads(model), want_g, "generator")
    lr = cfg.train.learning_rate
    _assert_params(model, convert.state_dict_from_jax(want["gen"], cfg), want_g, g_tols, lr)
    want_d, d_tols = None, {}
    if kind == "gan":
        want_d = convert.discriminator_state_dict_from_jax(
            {"params": want["dis_grads"], "batch_stats": init["dis"]["batch_stats"]})
        d_tols = _assert_grads(_grads(disc), want_d, "discriminator")
    else:
        assert not _grads(disc)
    _assert_params(disc, convert.discriminator_state_dict_from_jax(want["dis"]), want_d,
                   d_tols, lr * cfg.train.dis_lr_scale, STATS_TOL)


def check_mm(got, want, init):
    cfg = tcfg.tiny_test_config("TED")
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    gen = _with(PoseGenerator(27, N_WORDS, N_SPEAKERS, cfg.baseline.hidden_size,
                              cfg.baseline.n_layers), got["gen"], got["gen_grads"])
    _check_net(gen, convert.pose_generator_state_dict_from_jax, init["gen"],
               want["gen_grads"], want["gen"], cfg.train.learning_rate, "generator")
    assert not got["dis_grads"]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_two_ranks_match_the_sharded_jax_step(runs, ranks, case):
    want, inits, _ = runs
    name = case["name"]
    for got in ranks:
        got = got["zero"]
        if case["family"] == "hop":
            check_hop(got[name], want[name], inits["hop"], case["kind"])
        else:
            check_mm(got[name], want[name], inits["mm"])
    # the ranks end equal, bit for bit
    r0, r1 = (got["zero"][name] for got in ranks)
    assert differing_entries({k: r0[k] for k in ("gen", "dis", "gen_opt", "dis_opt")},
                             {k: r1[k] for k in ("gen", "dis", "gen_opt", "dis_opt")}) == []


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_zero2_is_bitwise_the_unsharded_optimizer(ranks, case):
    name = case["name"]
    on, off = ranks[0]["zero"][name], ranks[0]["no_zero"][name]
    keys = ("gen", "dis", "gen_opt", "dis_opt", "metrics")
    assert differing_entries({k: on[k] for k in keys}, {k: off[k] for k in keys}) == []
    assert on["zero_axes"] and sum(ax is not None for ax in on["zero_axes"]) > 5
    assert off["zero_axes"] is None


def test_batchnorm_on_local_statistics_fails_the_comparison(runs, ranks):
    """The planted fault: each rank normalising by its own rows' statistics
    (what a port without the batch group's all-reduce computes)."""
    want, inits, _ = runs
    with pytest.raises(AssertionError):
        check_hop(ranks[0]["local_bn"]["hop_gan"], want["hop_gan"], inits["hop"], "gan")
