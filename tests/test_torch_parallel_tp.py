"""The frozen backbone's tensor parallelism (models/bert.py, models/llama.py
`shard_`) on a model group of 2 ranks (gloo on the CPU, one thread a rank),
and one HOP step on data = 2 x model = 2 (4 ranks).

  * The tiny BERT (4 heads: 2 a rank) on each attention route's plain
    version and the tiny LLaMA (4 heads and 2 KV heads: 2 and 1 a rank):
    forward and the input's gradient for a fixed cotangent against
    hop_tpu's unsharded encoder, at 1e-5 of the largest element. Every
    bias and LayerNorm of the BERT is drawn away from its init, so that a
    bias added on every rank shows.
  * The planted faults (set in the ranks' processes by
    tests/torch_parallel_worker.py): no copy-to-group before the
    column-parallel products (the input's gradient keeps one rank's share of
    them), and the row-parallel bias added on every rank (twice in the sum):
    each must fail that comparison.
  * The fused HOP GAN step at global batch 8 on data = 2 x model = 2 against
    the one-process port step from the same state and draws, at
    tests/test_torch_train_step.py's tolerances; the trainable parameters,
    the discriminator and the optimizer states end bitwise equal on all four
    ranks.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu.models.bert import BertEncoder as JaxBert

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import _bert, _llama
from hop_tpu_torch.data.synthetic import make_host_batch
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.ops import mel as mel_ops
from hop_tpu_torch.train.llm import StepNoise, make_hop_train_steps
from hop_tpu_torch.utils.checkpoint import differing_entries, strip_frozen

from test_torch_llama import _jax_encoder, _llm
from test_torch_parallel_step import _with, launch
from test_torch_train_step import (LOSS_RTOL, STATS_TOL, _assert_grads, _assert_params,
                                   _grads, one_torch_thread)  # noqa: F401 (a fixture)

TP_TOL = 1e-5       # of the largest element
DP2MP2_CASE = {"name": "hop_gan", "family": "hop", "kind": "gan", "epoch": 1}
ROUTES = ["plain", "fused", "block"]
B = 8


def _bert_params(llm, seed):
    enc = JaxBert(llm)
    x = jnp.zeros((1, 5, llm.dim))
    params = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(
        jax.jit(lambda k: enc.init(k, x, True))(jax.random.PRNGKey(seed))["params"]))
    r = np.random.default_rng(seed + 1)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bias", "scale"):
                tree[k] = (v + r.normal(0, 0.1, v.shape)).astype(np.float32)
    perturb(params)
    params.setdefault("word_embeddings", {"embedding": r.normal(
        0, 0.02, (llm.vocab_size, llm.dim)).astype(np.float32)})
    return enc, params


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """hop_tpu's unsharded outputs and input gradients, and the ranks' runs:
    the encoders' on 2 ranks and the data = 2 x model = 2 step's on 4, both
    launched before hop_tpu's side is computed, so that they run meanwhile."""
    r = np.random.default_rng(0)
    bert_llm = dataclasses.replace(jcfg.tiny_test_config("TED").llm, compute_bf16=False)
    jbert, bparams = _bert_params(bert_llm, seed=4)
    port_llama, ref_llama = _llm(n_kv=2)
    jllama, lparams = _jax_encoder(ref_llama, seed=0)
    x = r.standard_normal((3, 34, 64)).astype(np.float32)
    w = r.standard_normal((3, 34, 64)).astype(np.float32)

    bert_sd, llama_sd = {}, {}
    _bert(bert_sd, "", bparams, bert_llm.n_layers)
    _llama(llama_sd, "", lparams, port_llama.n_layers)
    port_bert = dataclasses.replace(tcfg.tiny_test_config("TED").llm, compute_bf16=False)
    bert = {"job": "tp", "llm": port_bert, "sd": bert_sd, "x": x, "w": w}
    llama = {"job": "tp", "llm": port_llama, "sd": llama_sd, "x": x, "w": w}
    jobs = {**{f"bert_{route}": dict(bert, route=route) for route in ROUTES},
            "llama": llama,
            "bert_no_copy": dict(bert, route="plain", fault="no_copy"),
            "llama_no_copy": dict(llama, fault="no_copy"),
            "bert_bias_every_rank": dict(bert, route="plain", fault="bias_every_rank")}
    cfg, hop = _port_spec()
    step_job = {"job": "step", "cases": [DP2MP2_CASE], "hop": hop}
    # one world at a time: at most 4 rank processes beside the other test workers
    pool = concurrent.futures.ThreadPoolExecutor(1)
    got = pool.submit(launch, {"model_parallel": 2, "jobs": jobs},
                      tmp_path_factory.mktemp("tp"), "tp", world=2)
    step = pool.submit(launch, {"data_parallel": 2, "model_parallel": 2,
                                "jobs": {"step": step_job}},
                       tmp_path_factory.mktemp("dp2mp2"), "dp2mp2", world=4)
    pool.shutdown(wait=False)

    want = {}
    for name, fn in (("bert", lambda x: jbert.apply({"params": bparams}, x, True)),
                     ("llama", lambda x: jllama.apply({"params": lparams}, x))):
        out, vjp = jax.vjp(fn, jnp.asarray(x))
        want[name] = {"out": np.asarray(out), "x_grad": np.asarray(vjp(jnp.asarray(w))[0])}
    return want, got.result(), (cfg, hop, step)


def check_encoder(got, want):
    for key in ("out", "x_grad"):
        tol = TP_TOL * np.abs(want[key]).max()
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("name", [f"bert_{r}" for r in ROUTES] + ["llama"])
def test_sharded_encoder_matches_jax(encoders, name):
    want, got, _ = encoders
    for rank in got:
        check_encoder(rank[name], want[name.split("_")[0]])
    assert torch.equal(got[0][name]["x_grad"], got[1][name]["x_grad"])


@pytest.mark.parametrize("name", ["bert_no_copy", "llama_no_copy", "bert_bias_every_rank"])
def test_planted_fault_fails_the_comparison(encoders, name):
    want, got, _ = encoders
    with pytest.raises(AssertionError):
        check_encoder(got[0][name], want[name.split("_")[0]])


def _port_spec():
    """The tiny HOP generator and discriminator from the port's init, a
    global batch of 8 and one fused GAN step's draws for it."""
    cfg = tcfg.tiny_test_config("TED")
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        gen, disc = HOPModel(cfg, 10), ConvDiscriminator(27, 34)
    hb = make_host_batch(cfg, B, seed=3, n_speakers=10)
    d = cfg.data
    hb["log_mel"] = mel_ops.log_mel_spectrogram(
        torch.tensor(hb["in_audio"]), sr=d.sample_rate, n_fft=d.mel_n_fft, hop=d.mel_hop,
        n_mels=d.mel_bins).numpy()
    hb["text_padded"] = hb["text_padded"] % cfg.llm.vocab_size
    hb = {k: hb[k] for k in ("in_audio", "log_mel", "text_padded", "target_vec",
                             "vid_indices")}
    noise = StepNoise.draw(torch.Generator().manual_seed(9), cfg, B)
    noise = {f.name: getattr(noise, f.name) for f in dataclasses.fields(noise)}
    return cfg, {"gen": gen.state_dict(), "dis": disc.state_dict(), "n_speakers": 10,
                 "batch": hb, "noise": {"gan": noise}}


def test_data2_model2_step_matches_one_process(encoders):
    cfg, hop, got = encoders[2]
    got = got.result()
    assert [g["coords"] for g in got] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]

    gen, disc = HOPModel(cfg, 10), ConvDiscriminator(27, 34)
    gen.load_state_dict(hop["gen"])
    disc.load_state_dict(hop["dis"])
    gen.llm_model.dropout_rate = 0.0
    gen.reprogramming_layer.attention_dropout = 0.0
    disc.gru.dropout = 0.0
    _, gan, init_state = make_hop_train_steps(cfg, gen, disc)
    _, metrics = gan.for_epoch(1)(init_state(), {k: torch.tensor(v) for k, v in
                                                 hop["batch"].items()},
                                  StepNoise(**hop["noise"]["gan"]))
    want_g, want_d = _grads(gen), _grads(disc)
    lr = cfg.train.learning_rate
    for rank in got:
        r = rank["step"]["hop_gan"]
        for k, v in metrics.items():
            np.testing.assert_allclose(r["metrics"][k], v.item(), rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=k)
        frozen = strip_frozen(gen.state_dict())[1]
        port = _with(HOPModel(cfg, 10), {**r["gen"], **frozen}, r["gen_grads"])
        tols = _assert_grads(_grads(port), want_g, "generator")
        _assert_params(port, gen.state_dict(), want_g, tols, lr)
        pdisc = _with(ConvDiscriminator(27, 34), r["dis"], r["dis_grads"])
        tols = _assert_grads(_grads(pdisc), want_d, "discriminator")
        _assert_params(pdisc, disc.state_dict(), want_d, tols,
                       lr * cfg.train.dis_lr_scale, STATS_TOL)
    # the trainable state ends bit for bit equal on every rank
    first = got[0]["step"]["hop_gan"]
    for rank in got[1:]:
        r = rank["step"]["hop_gan"]
        a = {"gen": strip_frozen(first["gen"])[0], "dis": first["dis"],
             "opt": [first["gen_opt"], first["dis_opt"]]}
        b = {"gen": strip_frozen(r["gen"])[0], "dis": r["dis"],
             "opt": [r["gen_opt"], r["dis_opt"]]}
        assert differing_entries(a, b) == []
