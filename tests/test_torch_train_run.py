"""The training run as a whole, on the CPU at tiny_test_config("TED").

1. The port's `run_training` with the real HOP steps against hop_tpu's
   (`hop_tpu.train.loops.run_training` with `hop_tpu.train.llm`'s steps),
   from identical converted state: B=4, 2 epochs of the same 2 batches,
   `warmup_epochs=0` (epoch 0 runs the fused warmup step's epoch-0
   variant, epoch 1 the fused GAN step's steady variant), dropout off on
   both sides as in tests/test_torch_train_step.py, scripted validation
   results and a fake checkpoint manager. hop_tpu's loop gives step i of
   epoch e the key `fold_in(fold_in(train_key(seed), e), i)`; the same key's
   draws (train/llm.py:197-200, :213, models/hop.py:116-118, llm.py:166-169)
   go to the port's loop as its `StepNoise` through its `rng` hook.

   Tolerances (N = the Adam steps a net took: 4 for the generator, 2 for
   the discriminator):
     * every step's losses and metrics: 1e-4 relative (atol 1e-6);
     * Adam's moments, each tensor: the port's m and v within 0.25 of the
       largest element of hop_tpu's mu and nu (MOMENT_REL);
     * parameters, each tensor: ||p_port - p_jax|| within 3e-2 of
       ||p_jax - p_init||, the distance the run moved it (PARAM_REL);
     * a tensor whose gradient is exactly zero (the conv biases in front of
       a BatchNorm, the prototype key projection's bias under the softmax),
       known by hop_tpu's mu staying below 1e-5 of its net's largest: the
       port's m stays below that too, and its elements within N * 2 * lr
       (Adam moves them by a round-off-signed step of up to lr a step on
       either side, so nothing tighter holds);
     * BatchNorm running statistics: F * N * 1e-5 (test_torch_train_step's
       1e-5 a step) plus F * 0.1 * 2 * lr * N (N - 1) / 2, with F the
       forwards a step runs through the net (1 through gwnet, the fused
       step's one trunk; 3 through the discriminator: G term, real, fake):
       those zero-gradient biases differ by up to 2 k lr by step k, and
       each forward's running mean takes momentum 0.1 of that
       (test_torch_train_step's exception for the 3-forward step);
   and the saves, the metadata, the JSONL lines and the best FGD are equal.

   Where the limits come from. The rule written before the first run held
   the elements whose final m is above 1e-3 of their tensor's largest to
   N * lr * 1e-3 (test_torch_train_step's one-step rule, scaled) and the
   statistics to N * 1e-5; it failed (3.1e-3 on gwnet.end_conv_1.weight,
   9.2e-3 on gwnet's running means), as does holding the moments to
   N * 1e-4 of each tensor's largest: Adam's later steps move an element by
   lr * m / sqrt(v), not +-lr, and a step's gradient is taken at parameters
   that already differ, so the one-step rules do not scale. The limits
   above sit between two sets of readings of this test's run, each the
   largest over the tensors that are not zero-gradient (CPU, torch 2.13):
     * the port in f32 against hop_tpu, at 1, 2, 4 and 8 CPU threads:
       m 7.3e-2 (beat.0.bias), v 2.7e-2, parameters 8.2e-3
       (gwnet.end_conv_1.weight) in the generator; m 2.3e-4, v 4.3e-4,
       parameters 2.3e-3 in the discriminator;
     * planted faults in the port: the generator's 4th update dropped: m
       4.1, v 0.87, parameters 0.36 (and at least 9.1e-2 in EVERY tensor);
       the discriminator's 2nd update dropped: m 1.6, v 1.0, parameters
       0.60 (at least 0.49 in every tensor); the discriminator's lr
       doubled: m 1.9, v 3.5, parameters 1.06 (at least 0.89 everywhere).
   This is rounding, not a port fault: the same port code run in f64 ends
   within 4.1e-4 (parameters) and 8.6e-3 (m) of hop_tpu's f32 run in the
   generator, 4.7e-5 on gwnet.end_conv_1.weight, and 9.8e-4 in the
   discriminator. The port's f32 run is the one that strays from its own
   f64 run (8.2e-3 on end_conv_1), while changing its thread count moves
   it by at most 3.4e-3 (1.3e-4 on end_conv_1): the port's f32 arithmetic
   on the CPU is less accurate than XLA's here (ROADMAP.md Queue 3).

2. On the port alone, through `python -m hop_tpu_torch.cli.run_ted`'s
   `main` with `--device cpu --tiny`: 4 epochs equal 2 epochs plus
   `--resume` to 4, and prefetch 2 equals prefetch 0, bit for bit in every
   tensor of the last checkpoint, the metric stream and the best-FGD
   record; `cli.test_checkpoint --checkpoint-dir` restores that run, and
   its long-form output equals the trained model's in memory. These run on
   one CPU thread: MKL's threaded GEMMs may split a sum differently from
   one call to the next (tests/test_torch_checkpoint.py).
"""

import contextlib
import dataclasses
import io
import json
import os
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.eval.evaluate import EvalResult as JaxEvalResult
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.multimodal_context import ConvDiscriminator as JaxDisc
from hop_tpu.train import loops as jloops
from hop_tpu.train.llm import make_hop_train_steps as jax_make_steps
from hop_tpu.utils.prng import train_key

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli import run_ted, test_checkpoint
from hop_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from hop_tpu_torch.eval.evaluate import EvalResult
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.train.llm import StepNoise, make_hop_train_steps
from hop_tpu_torch.train.loops import run_training
from hop_tpu_torch.utils.checkpoint import (CheckpointManager, differing_entries,
                                            flat_entries)

B = 4
N_SPEAKERS = 10
SEED = 2021
EPOCHS = 2
LOSS_RTOL = 1e-4
STATS_TOL = 1e-5
ZERO_GRAD_REL = 1e-5
MOMENT_REL = 0.25
PARAM_REL = 3e-2
BATCH_KEYS = ("in_audio", "log_mel", "text_padded", "target_vec", "vid_indices")
FGDS = [3.0, 2.0]


def _f32(cfg):
    return cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False),
                       loss=dataclasses.replace(cfg.loss, warmup_epochs=0))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, flax_meta.unbox(tree))


def _no_dropout(self, inputs, *args, **kwargs):
    return inputs


class Recorder:
    """Wraps an EpochStep: the same variants, each call's metrics kept."""

    def __init__(self, step, log):
        self.step, self.log = step, log

    def for_epoch(self, epoch):
        inner = self.step.for_epoch(epoch)

        def call(state, batch, rng):
            state, metrics = inner(state, batch, rng)
            self.log.append((epoch, metrics))
            return state, metrics
        return call


class FakeCkpt:
    metadata = None

    def __init__(self):
        self.saved, self.bests = [], []

    def save(self, step, state, metadata=None):
        self.saved.append((step, dict(metadata)))

    def record_best(self, name, value, step):
        self.bests.append((step, value))
        return True


def _eval_fn(Result):
    fgds = iter(FGDS)

    def eval_fn(state, epoch):
        return Result(loss=1.0, mae=0.1, frechet_dist=next(fgds), feat_dist=0.2,
                      bc=0.0, diversity=1.0, elapsed_sec=0.0)
    return eval_fn


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """hop_tpu's run: the batches, the initial variables, the per-step
    metrics, the saves and the final state."""
    tmp = tmp_path_factory.mktemp("jax_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOP_TPU_PALLAS_REPROG", raising=False)
        mp.delenv("HOP_TPU_PALLAS_GRU", raising=False)
        mp.setenv("HOP_TPU_PALLAS_BLOCK_ATTN", "0")
        mp.setattr(fnn.Dropout, "__call__", _no_dropout)
        cfg = _f32(jcfg.tiny_test_config("TED"))
        batches = []
        for seed in (0, 1):
            nb = jsynthetic.make_batch(cfg, B, seed=seed)
            nb["text_padded"] = nb["text_padded"] % cfg.llm.vocab_size
            nb = jsynthetic.add_device_features(nb, cfg)
            batches.append({k: np.asarray(nb[k]) for k in BATCH_KEYS})
        jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
        model, disc = JaxHOP(cfg, n_speakers=N_SPEAKERS), JaxDisc()
        gen_vars = jax.jit(lambda key: model.init(
            {"params": key, "dropout": key}, jb["in_audio"], jb["log_mel"],
            jb["text_padded"], jb["target_vec"][:, :16], jb["vid_indices"],
            rng=key, train=True))(jax.random.PRNGKey(0))
        dis_vars = jax.jit(lambda key: disc.init(
            {"params": key, "dropout": key}, jb["target_vec"], train=True))(
            jax.random.PRNGKey(2))
        init = {"gen": _numpy(gen_vars), "dis": _numpy(dis_vars)}
        # BN statistics away from (0, 1), so that their updates show
        r = np.random.default_rng(3)
        for stats in (init["gen"]["batch_stats"]["gwnet"], init["dis"]["batch_stats"]):
            for bn in jax.tree_util.tree_leaves(
                    stats, is_leaf=lambda t: isinstance(t, dict) and "mean" in t):
                bn["mean"] = r.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
                bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)

        warmup, gan, init_state = jax_make_steps(cfg, model, disc)
        log, ckpt = [], FakeCkpt()
        gen = jax.tree_util.tree_map(jnp.asarray, {**gen_vars, "batch_stats":
                                                   init["gen"]["batch_stats"]})
        dis = jax.tree_util.tree_map(jnp.asarray, {**dis_vars, "batch_stats":
                                                   init["dis"]["batch_stats"]})

        def batches_fn(epoch):
            for b in batches:
                yield {k: jnp.asarray(v) for k, v in b.items()}
        path = tmp / "jax.jsonl"
        state, best = jloops.run_training(
            cfg, batches_fn, Recorder(warmup, log), Recorder(gan, log),
            init_state(gen, dis), rng=train_key(SEED), eval_fn=_eval_fn(JaxEvalResult),
            checkpoint_manager=ckpt, metric_path=str(path), log_every=1, epochs=EPOCHS)
        gen_adam = state.gen_opt_state.inner_states["train"].inner_state[0]
        gen_mu, gen_nu = _numpy(gen_adam.mu), _numpy(gen_adam.nu)
        for tree in (gen_mu, gen_nu):
            tree.pop("llm")          # the frozen backbone: set_to_zero, no moments
        dis_adam = state.dis_opt_state[0]
        return dict(
            cfg=cfg, batches=batches, init=init, best=best, saved=ckpt.saved,
            bests=ckpt.bests, lines=path.read_text().splitlines(),
            metrics=[(e, {k: float(v) for k, v in m.items()}) for e, m in log],
            gen={"params": _numpy(state.gen_params), "batch_stats": _numpy(state.gen_stats)},
            dis={"params": _numpy(state.dis_params), "batch_stats": _numpy(state.dis_stats)},
            gen_moments=(gen_mu, gen_nu),
            dis_moments=(_numpy(dis_adam.mu), _numpy(dis_adam.nu)))


def _t(a):
    return torch.tensor(np.asarray(a))


def jax_step_noise(cfg, batch, key):
    """The draws of hop_tpu's fused step for `key` (test_torch_train_step's
    `jax_noise` for any key), as a StepNoise."""
    rng_fwd, _, rng_d = jax.random.split(key, 3)
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
    return StepNoise(eps=_t(jax.random.normal(rng_a, (B, z))),
                     eps_rand=_t(jax.random.normal(rng_b, (B, z))),
                     perm=_t(perm).long(),
                     target_noise=_t(jax.random.normal(rng_nt, shape)),
                     fake_noise=_t(jax.random.normal(rng_nf, shape)),
                     reprog_seed=0, dropout_seed=0)


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_run")
    cfg = _f32(tcfg.tiny_test_config("TED"))
    init = jax_run["init"]
    model = HOPModel(cfg, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(init["gen"], cfg), strict=True)
    disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(discriminator_state_dict_from_jax(init["dis"]), strict=True)
    model.llm_model.dropout_rate = 0.0
    model.reprogramming_layer.attention_dropout = 0.0
    disc.gru.dropout = 0.0
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    batches = [{k: torch.tensor(v) for k, v in b.items()} for b in jax_run["batches"]]
    root = train_key(SEED)

    def rng(epoch, i):
        key = jax.random.fold_in(jax.random.fold_in(root, epoch), i)
        return jax_step_noise(cfg, jax_run["batches"][i], key)
    log, ckpt = [], FakeCkpt()
    path = tmp / "port.jsonl"
    state, best = run_training(
        cfg, lambda epoch: iter(batches), Recorder(warmup, log), Recorder(gan, log),
        init_state(), rng=rng, eval_fn=_eval_fn(EvalResult), checkpoint_manager=ckpt,
        metric_path=str(path), log_every=1, epochs=EPOCHS)
    return dict(cfg=cfg, state=state, best=best, saved=ckpt.saved, bests=ckpt.bests,
                lines=path.read_text().splitlines(),
                metrics=[(e, {k: v.item() for k, v in m.items()}) for e, m in log])


def test_run_steps_and_records_match_jax(jax_run, port_run):
    assert [e for e, _ in port_run["metrics"]] == [e for e, _ in jax_run["metrics"]] \
        == [0, 0, 1, 1]
    for (_, got), (_, want) in zip(port_run["metrics"], jax_run["metrics"]):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert "dis" in port_run["metrics"][-1][1] and "dis" not in port_run["metrics"][0][1]
    assert port_run["best"] == jax_run["best"] == min(FGDS)
    assert port_run["bests"] == jax_run["bests"]
    assert port_run["lines"] == jax_run["lines"]
    assert len(port_run["saved"]) == len(jax_run["saved"]) == EPOCHS
    for (s1, got), (s2, want) in zip(port_run["saved"], jax_run["saved"]):
        got.pop("div_history")
        assert (s1, got) == (s2, want)
    assert port_run["state"].step == 2 * EPOCHS


def _jax_moments(jax_run, cfg):
    """hop_tpu's final Adam moments, ((mu, nu) of the generator, of the
    discriminator), in the port's names and layouts."""
    init = jax_run["init"]
    gen = tuple(state_dict_from_jax({"params": {**init["gen"]["params"], **t},
                                     "batch_stats": init["gen"]["batch_stats"]}, cfg)
                for t in jax_run["gen_moments"])
    dis = tuple(discriminator_state_dict_from_jax(
        {"params": t, "batch_stats": init["dis"]["batch_stats"]})
        for t in jax_run["dis_moments"])
    return gen, dis


def _port_moments(opt, module):
    """{parameter name: (exp_avg, exp_avg_sq)} of a torch Adam over `module`."""
    names = {id(p): k for k, p in module.named_parameters()}
    return {names[id(p)]: (s["exp_avg"], s["exp_avg_sq"]) for p, s in opt.state.items()}


def _assert_run_state(module, opt, want_sd, init_sd, want_moments, lr, n_steps,
                      forwards):
    mu, nu = want_moments
    port = _port_moments(opt, module)
    zero = ZERO_GRAD_REL * max(mu[k].abs().max().item() for k in port)
    got_sd = module.state_dict()
    stats_tol = forwards * (n_steps * STATS_TOL + 0.1 * 2 * lr * n_steps * (n_steps - 1) / 2)
    for k, v in got_sd.items():
        w = want_sd[k]
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, w, rtol=0, atol=stats_tol, msg=k)
            continue
        if k not in port:
            # no gradient reached it: the frozen backbone (checked apart) or
            # a parameter the forward does not use, which neither side moves
            if not k.startswith("llm_model."):
                assert torch.equal(v, init_sd[k]) and torch.equal(w, init_sd[k]), k
            continue
        m, v2 = port[k]
        if mu[k].abs().max().item() < zero:          # an exactly zero gradient
            assert m.abs().max().item() < zero, f"{k}: m not ~0"
            assert (v - w).abs().max().item() <= n_steps * 2 * lr, k
            continue
        for name, got, want in (("m", m, mu[k]), ("v", v2, nu[k])):
            err = (got - want).abs().max().item() / want.abs().max().item()
            assert err <= MOMENT_REL, f"{k}: Adam's {name} off by {err:.3g} of its largest"
        rel = (v - w).norm().item() / (w - init_sd[k]).norm().item()
        assert rel <= PARAM_REL, f"{k}: {rel:.3g} of the distance it moved"


def test_run_final_state_matches_jax(jax_run, port_run):
    cfg = port_run["cfg"]
    state = port_run["state"]
    init = jax_run["init"]
    lr = cfg.train.learning_rate
    gen_moments, dis_moments = _jax_moments(jax_run, cfg)
    frozen = state_dict_from_jax(init["gen"], cfg)
    _assert_run_state(state.model, state.gen_opt, state_dict_from_jax(jax_run["gen"], cfg),
                      frozen, gen_moments, lr, 2 * EPOCHS, forwards=1)
    _assert_run_state(state.disc, state.dis_opt,
                      discriminator_state_dict_from_jax(jax_run["dis"]),
                      discriminator_state_dict_from_jax(init["dis"]), dis_moments,
                      lr * cfg.train.dis_lr_scale, EPOCHS, forwards=3)
    for k, v in state.model.state_dict().items():
        if k.startswith("llm_model."):
            assert torch.equal(v, frozen[k]), f"frozen {k} changed"


# -- the port alone, through the entry points --------------------------------

RUN = ["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
       "--warmup-epochs", "0", "--log-every", "1"]
CLIP = ["--device", "cpu", "--tiny", "--clip-seconds", "3", "--vid", "1"]


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Run A: 4 epochs, prefetch 0. Run B: 2 epochs, then --resume to 4.
    Run C: 4 epochs, prefetch 2. One CPU thread (see the docstring)."""
    tmp = tmp_path_factory.mktemp("cli")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tempfile, "tempdir", str(tmp))
            dirs, states = {}, {}

            def run(name, *extra):
                d = dirs[name] = str(tmp / name)
                states[name] = _quiet(run_ted.main, RUN + [
                    "--checkpoint-dir", d, "--metrics", os.path.join(d, "metrics.jsonl"),
                    *extra])[0]
            run("A", "--epochs", "4")
            run("B", "--epochs", "2")
            run("B", "--epochs", "4", "--resume")
            run("C", "--epochs", "4", "--prefetch", "2")
            restored = _quiet(test_checkpoint.main, CLIP + ["--checkpoint-dir", dirs["A"]])
            in_memory = _quiet(test_checkpoint.main, CLIP, model=states["A"].model)
    finally:
        torch.set_num_threads(n)
    return dirs, states, restored, in_memory


@pytest.mark.parametrize("other", ["B", "C"], ids=["resume", "prefetch"])
def test_cli_run_is_bit_identical(cli_runs, other):
    dirs, _, _, _ = cli_runs
    a, b = (CheckpointManager(dirs[x]).restore() for x in ("A", other))
    assert len(flat_entries(a)) > 100
    assert differing_entries(a, b) == []
    assert a["step"] == 4 * 3
    for f in ("metrics.jsonl", "best_metrics.json"):
        got, want = (open(os.path.join(dirs[x], f)).read() for x in ("A", other))
        assert got == want, f
    meta = json.loads(open(os.path.join(dirs[other], "run_metadata.json")).read())
    assert meta["epoch"] == 3 and meta["step"] == 3 and meta["seed"] == SEED


def test_test_checkpoint_restores_the_trained_model(cli_runs):
    dirs, states, restored, in_memory = cli_runs
    assert restored.ndim == 2 and restored.shape == in_memory.shape
    np.testing.assert_array_equal(restored, in_memory)
    fresh = _quiet(test_checkpoint.main, CLIP)
    assert not np.array_equal(fresh, restored)
