"""The hierarchy's train steps in the port (hop_tpu_torch.train.hierarchy)
against hop_tpu.train.hierarchy's: the contrastive and physical losses
(values and gradients), and one warmup and one GAN step of the TED cascade
(3 stages) from identical state; the Expressive cascade's (6 stages) are in
test_torch_hierarchy_steps_expressive.py, on this file's helpers.

Thin widths on both datasets, as hop_tpu's own step tests use them: the
stages and the text encoder at hidden 16 and 2 layers, ResNetSE(layers=
(1, 1, 1, 1)); B = 4, inputs from a numpy seed, the loss weights hop_tpu's
train_main sets (contrastive 0.1 / 0.05, physical 0.01). The state starts
from the port's seeded init (BatchNorm statistics moved away from (0, 1)),
carried to hop_tpu through its own importers (`convert_resnet_se`,
`convert_text_encoder_tcn`, `convert_hierarchical_generator`,
`convert_conv_discriminator`; test_torch_hierarchy_models.py holds their
round trips): flax's init of the conv net compiles for longer than the step.

hop_tpu's steps run in f64 (`jax.enable_x64`, its GRU's `dtype` field
set to f64 by a monkeypatch; no file of hop_tpu changes), the port in f32:
the ResNetSE's first BatchNorm sees the spectrogram in dB (mean near -45,
spread near 5), where flax's f32 variance E[x^2] - E[x]^2 cancels and
leaves hop_tpu's f32 gradients of the audio encoder 1e-2 off their f64
values; the port takes the variance about the mean
(`common.CenteredBatchNorm2d`) and stays within 2e-5 of them.

Dropout is off on both sides; JAX's draws (the speaker noise of every stage
of each cascade, the permutation; hop_tpu/train/hierarchy.py:106, :122-124,
:146, :225) are handed to the port as its `StepNoise`. Tolerances, those of
tests/test_torch_train_step.py: losses 2e-5 relative; each gradient tensor
1e-4 of its largest element (a tensor below 1e-5 of its net's largest is
round-off of an exactly zero gradient on both sides); BatchNorm running
statistics 1e-5; updated parameters lr * 1e-3 where the gradient is
resolved, else a step of at most 2 lr. The loss functions alone: values
2e-5 relative, gradients 1e-4 of their largest element.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hop_tpu import geometry as jgeometry
from hop_tpu.config import tiny_test_config as jax_tiny
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.eval import torch_import_generator as jimport
from hop_tpu.models import hierarchy as JH
from hop_tpu.models.resnet_se import ResNetSE as JaxResNetSE
from hop_tpu.ops.gru import GRU as JaxGRU
from hop_tpu.train import hierarchy as jtrain
from hop_tpu.train import hierarchy_expressive_stats as jhx

from hop_tpu_torch import convert, geometry
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.hierarchy import HierarchicalConvDiscriminator, HierarchyNet
from hop_tpu_torch.train import hierarchy as T
from hop_tpu_torch.train.llm import StepNoise

from test_torch_train_step import GRAD_REL, LOSS_RTOL, _perm
from test_torch_zoo_steps import (_cast, _check_metrics, _check_net, _grads,  # noqa: F401
                                  _grads_of, _jnp, _no_port_dropout, _numpy, no_dropout,
                                  one_torch_thread)

B, N_WORDS, N_SPEAKERS, HIDDEN, LAYERS = 4, 50, 10, 16, 2
THIN = (1, 1, 1, 1)
STEP_KEY = 13
KEYS = ("spectrogram", "text_padded", "target_vec", "vid_indices")


def _configs(dataset):
    """The port's and hop_tpu's configs at the thin widths; hop_tpu's with
    the loss weights its train_main sets for the hierarchy (the port's
    `train.hierarchy` constants)."""
    def thin(cfg):
        return cfg.replace(
            baseline=dataclasses.replace(cfg.baseline, hidden_size=HIDDEN, n_layers=LAYERS))
    cfg_j = thin(jax_tiny(dataset))
    cfg_j = cfg_j.replace(loss=dataclasses.replace(
        cfg_j.loss, contrastive_pos_weight=T.CONTRASTIVE_POS_WEIGHT,
        contrastive_neg_weight=T.CONTRASTIVE_NEG_WEIGHT, physical_weight=T.PHYSICAL_WEIGHT))
    return thin(tiny_test_config(dataset)), cfg_j


def _batch(cfg_j):
    b = jsynthetic.add_device_features(jsynthetic.make_batch(cfg_j, B, seed=0), cfg_j)
    b = {k: np.asarray(b[k]) for k in KEYS}
    b["spectrogram"] = b["spectrogram"].astype(np.float32)
    b["text_padded"] = b["text_padded"] % N_WORDS
    b["vid_indices"] = b["vid_indices"] % N_SPEAKERS
    return b


def _port_nets(cfg):
    """The port's nets from their seeded init, BatchNorm statistics away
    from (0, 1), dropout off."""
    torch.manual_seed(0)
    net = HierarchyNet(cfg, N_WORDS, N_SPEAKERS, resnet_layers=THIN)
    disc = HierarchicalConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    r = np.random.default_rng(3)
    for m in (*net.modules(), *disc.modules()):
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(torch.tensor(r.normal(0, 0.3, m.num_features)))
            m.running_var.copy_(torch.tensor(r.uniform(0.5, 1.5, m.num_features)))
    _no_port_dropout(net, disc)
    return net, disc


def _to_jax(net, disc):
    """The port's state -> hop_tpu's variable trees, through its importers."""
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    audio = jimport.convert_resnet_se(sub("audio."), layers=THIN)
    params = {"audio": audio["params"],
              "text": {"TextEncoderTCN_0": jimport.convert_text_encoder_tcn(
                  sub("text."), "", LAYERS)}}
    stats = {"audio": audio["batch_stats"], "text": {}}
    for k in range(len(net.stages)):
        params[f"g{k + 1}"] = jimport.convert_hierarchical_generator(
            sub(f"stages.{k}."), LAYERS, LAYERS)["params"]
        stats[f"g{k + 1}"] = {}
    dis = jimport.convert_conv_discriminator(
        {k: v.detach().numpy() for k, v in disc.state_dict().items()})
    return {"params": params, "batch_stats": stats}, dis


def _jax_modules(cfg_j):
    bones = JH.stage_bones(cfg_j.data.dataset)
    stages = [JH.HierarchicalPoseGenerator(pose_dim=len(bn) * 3, n_words=N_WORDS,
                                           n_speakers=N_SPEAKERS, hidden_size=HIDDEN,
                                           n_layers=LAYERS) for bn in bones]
    return (stages, JH.HierarchicalConvDiscriminator(),
            JaxResNetSE(n_speakers=N_SPEAKERS, pose_level=len(bones), layers=THIN),
            JH.HierarchicalTextEncoder(n_words=N_WORDS, hidden_size=HIDDEN, n_layers=LAYERS))


def hierarchy_runs(dataset, kinds=("warmup", "gan")):
    """hop_tpu's steps in f64 from the port's initial state: (batch, initial
    trees, {kind: metrics, gradients and new state in f32, and the step's
    draws as a StepNoise})."""
    cfg, cfg_j = _configs(dataset)
    batch = _batch(cfg_j)
    gen, dis = _to_jax(*_port_nets(cfg))
    runs = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        # hop_tpu's GRU carries its state in its `dtype` field, f32 by default
        mp.setattr(JH, "GRU", functools.partial(JaxGRU, dtype=jnp.float64))
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
              for k, v in batch.items()}
        for kind in kinds:
            warmup, gan, init_state = jtrain.make_hierarchy_train_steps(
                cfg_j, *_jax_modules(cfg_j))
            state, metrics = (warmup if kind == "warmup" else gan)(
                init_state(_jnp(_cast(gen, np.float64)), _jnp(_cast(dis, np.float64))),
                jb, jax.random.PRNGKey(STEP_KEY))

            def f32(tree):
                return _cast(_numpy(tree), np.float32)
            runs[kind] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                gen_grads=f32(_grads_of(state.gen_opt_state)),
                dis_grads=f32(_grads_of(state.dis_opt_state)),
                gen={"params": f32(state.gen_params), "batch_stats": f32(state.gen_stats)},
                dis={"params": f32(state.dis_params), "batch_stats": f32(state.dis_stats)},
                noise=jax_hierarchy_noise(len(JH.stage_bones(dataset)),
                                          batch["vid_indices"], kind))
    return batch, {"gen": gen, "dis": dis}, runs


def jax_hierarchy_noise(n_stages, vids, kind):
    """The draws of hop_tpu's hierarchy step for key STEP_KEY, as f32: a
    cascade splits (rng, rk, rd) per stage and draws that stage's speaker
    noise from rk (hierarchy.py:106, common.py:27-32), in the step's dtype."""
    def cascade_eps(rng):
        eps = []
        for _ in range(n_stages):
            rng, rk, _ = jax.random.split(rng, 3)
            eps.append(np.asarray(jax.random.normal(rk, (B, 16), jnp.float64)))
        return torch.tensor(np.stack(eps), dtype=torch.float32)
    rng = jax.random.PRNGKey(STEP_KEY)
    eps_dis = torch.zeros(n_stages, B, 16)                  # unused by the warmup
    if kind == "gan":
        _, rng_c, _, rng = jax.random.split(rng, 4)         # hierarchy.py:225
        eps_dis = cascade_eps(rng_c)
    _, rng_c, rng_perm, rng_r, _ = jax.random.split(rng, 5)  # hierarchy.py:122
    return StepNoise(eps=cascade_eps(rng_c), eps_rand=cascade_eps(rng_r),
                     perm=torch.tensor(_perm(rng_perm, {"vid_indices": vids})).long(),
                     eps_dis=eps_dis, dropout_seed=0)


def check_step(runs, dataset, kind):
    batch, _, by_kind = runs
    cfg, _ = _configs(dataset)
    net, disc = _port_nets(cfg)
    warmup, gan, init_state = T.make_hierarchy_train_steps(cfg, net, disc)
    _, metrics = (warmup if kind == "warmup" else gan)(
        init_state(), {k: torch.tensor(v) for k, v in batch.items()}, by_kind[kind]["noise"])
    check_stepped(metrics, net, disc, runs, dataset, kind)


def check_stepped(metrics, net, disc, runs, dataset, kind):
    """The port's step (its metrics, and `net` and `disc` holding its updated
    state and gradients) against hop_tpu's of `runs`."""
    _, init, by_kind = runs
    want = by_kind[kind]
    cfg, _ = _configs(dataset)
    _check_metrics(metrics, want["metrics"])
    lr = cfg.train.learning_rate

    def to_sd(v):
        return convert.hierarchy_state_dict_from_jax(v, layers=THIN)
    _check_net(net, to_sd, init["gen"], want["gen_grads"], want["gen"], lr, "generator")
    to_dis = convert.discriminator_state_dict_from_jax
    if kind == "gan":
        lr_d = lr * cfg.train.dis_lr_scale
        # the G term runs on the UPDATED discriminator (see
        # test_torch_zoo_steps.py: 0.1 * 2 * lr_D on its running means)
        _check_net(disc, to_dis, init["dis"], want["dis_grads"], want["dis"], lr_d,
                   "discriminator", 1e-5 + 0.1 * 2 * lr_d)
    else:
        assert not _grads(disc)
        for k, v in disc.state_dict().items():
            assert torch.equal(v, to_dis(init["dis"])[k]), k


@pytest.fixture(scope="module")
def ted_runs(no_dropout):
    return hierarchy_runs("TED")


@pytest.mark.parametrize("kind", ["warmup", "gan"])
def test_ted_step_matches_jax(ted_runs, kind):
    check_step(ted_runs, "TED", kind)


# ---- the loss functions ------------------------------------------------------

def _value_and_grads(jax_fn, port_fn, *arrays):
    """(JAX's value and gradients, the port's) of a scalar function of
    `arrays`."""
    want, want_g = jax.jit(jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays)))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = port_fn(*ts)
    got.backward()
    return (float(want), [np.asarray(g) for g in want_g]), (got.item(),
                                                          [t.grad.numpy() for t in ts])


def _check_value_and_grads(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max())


@pytest.mark.parametrize("chunk_pairs", [T.CONTRASTIVE_CHUNK_PAIRS, 1000],
                         ids=["one-chunk", "chunked"])
def test_softmax_contrastive_matches_jax(chunk_pairs):
    """Text features with repeated rows (padded words) against audio
    features, in one chunk and in chunks of 1000 pairs (8 rows)."""
    r = np.random.default_rng(8)
    text = r.normal(size=(136, 32)).astype(np.float32)
    text[100:] = text[99]                                   # padding repeats a row
    audio = r.normal(size=(136, 32)).astype(np.float32)
    want, got = _value_and_grads(jtrain.softmax_contrastive,
                                 lambda a, b: T.softmax_contrastive(a, b, chunk_pairs),
                                 text, audio)
    _check_value_and_grads(want, got)


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_physical_loss_matches_jax(dataset):
    """The angle prior, with the palm pseudo-bones on TED Expressive."""
    skel = geometry.TED_SKELETON if dataset == "TED" else geometry.EXPRESSIVE_SKELETON
    jskel = jgeometry.TED_SKELETON if dataset == "TED" else jgeometry.EXPRESSIVE_SKELETON
    np.testing.assert_array_equal(np.asarray(skel.angle_pairs), np.asarray(jskel.angle_pairs))
    avg, var = ((JH.TED_AVG_ANGLE, JH.TED_VAR_ANGLE) if dataset == "TED"
                else (jhx.AVG_ANGLE, jhx.VAR_ANGLE))
    palms = dataset != "TED"
    out = (np.random.default_rng(9).normal(size=(3, 34, skel.pose_dim)) * 0.1
           ).astype(np.float32)
    want, got = _value_and_grads(
        lambda o: jtrain.physical_loss(o, jskel.mean_dir_vec, jskel.angle_pairs, avg, var,
                                       add_palms=palms),
        lambda o: T.physical_loss(o, skel.mean_dir_vec, skel.angle_pairs, avg, var,
                                  add_palms=palms), out)
    _check_value_and_grads(want, got)
