"""The hierarchy's modules in the port (hop_tpu_torch.models.resnet_se,
.hierarchy, the text-conditioned multimodal_context.Discriminator) against
hop_tpu's, from identical converted weights, inputs from a numpy seed, in
f32: torch's `F.pixel_shuffle` against hop_tpu's `pixel_shuffle` bitwise; `SELayer`, `SEBasicBlock`, `ResNetSE` at its
full (3, 4, 6, 3) depth, each stage generator of both cascades, both
hierarchical discriminators and the text Discriminator to 1e-5 of each
output's largest element, in eval mode and in training mode, where the
BatchNorm running statistics after the forward are held to 1e-5 of their
largest (at least 1e-5) too;
`route_pre_seq` bitwise on every transition of both cascades; the stage
tables and the angle statistics equal; the converters' round trips
JAX -> port -> hop_tpu's importer -> JAX bitwise.

The full-depth ResNetSE in training mode normalises 16 times by the
statistics of 3 samples, the first of them over a spectrogram in dB:
hop_tpu's own f32 forward is 4e-5 off its f64 one there (flax's variance
E[x^2] - E[x]^2 cancels; the port takes it about the mean,
`common.CenteredBatchNorm2d`), so that reference runs in f64
(`jax.enable_x64`) and the port in f32.

Dropout is off on both sides in training mode (flax's Dropout the
identity, the port's rates 0). The JAX modules run under jit (flax's
op-by-op init of a conv net is several times slower), torch on one thread
(`one_torch_thread`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hop_tpu.eval import torch_import_generator as jimport
from hop_tpu.models import hierarchy as JH
from hop_tpu.models import resnet_se as JR
from hop_tpu.models.multimodal_context import Discriminator as JaxTextDisc
from hop_tpu.train import hierarchy_expressive_stats as jhx

from hop_tpu_torch import convert
from hop_tpu_torch.models import hierarchy as H
from hop_tpu_torch.models import resnet_se as R
from hop_tpu_torch.models.multimodal_context import Discriminator
from hop_tpu_torch.train import hierarchy_expressive_stats as hx

from test_torch_zoo_steps import (_cast, _init, _no_port_dropout, no_dropout,  # noqa: F401
                                  one_torch_thread)

TOL = 1e-5
N_WORDS, N_SPEAKERS, B = 50, 10, 3
HIDDEN, LAYERS = 16, 2


def _np_tree(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def _apply(module, variables, *args, train=False, **kw):
    """JAX forward under jit: (outputs, updated batch_stats or None)."""
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    if train:
        out, upd = jax.jit(lambda v, *a: module.apply(v, *a, train=True,
                                                      mutable=["batch_stats"], **kw))(v, *args)
        return out, jax.tree_util.tree_map(np.asarray, upd.get("batch_stats", {}))
    return jax.jit(lambda v, *a: module.apply(v, *a, train=False, **kw))(v, *args), None


def _close(got, want, msg="", floor=0.0):
    """got to TOL of want's largest element (at least `floor`)."""
    want = torch.as_tensor(np.array(want, np.float32))
    torch.testing.assert_close(got, want, rtol=0, msg=msg,
                               atol=TOL * max(want.abs().max().item(), floor))


def _check_stats(port, to_sd, params, new_stats):
    want = to_sd({"params": params, "batch_stats": new_stats})
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, want[k], k, floor=1.0)


def test_pixel_shuffle_is_jax_s_bitwise():
    x = np.random.default_rng(0).normal(size=(2, 32, 5, 7)).astype(np.float32)
    want = np.asarray(JR.pixel_shuffle(jnp.asarray(x.transpose(0, 2, 3, 1)), 4))
    got = torch.nn.functional.pixel_shuffle(torch.tensor(x), 4).numpy()
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def _se_block_sd(variables):
    """The port's SEBasicBlock state_dict through the ResNetSE converter."""
    sd = convert.resnet_se_state_dict_from_jax(
        {"params": {"layer1_0": variables["params"],
                    **_STUB}, "batch_stats": {"layer1_0": variables["batch_stats"],
                                              **_STUB_STATS}}, layers=(1,))
    return {k[len("layer1.0."):]: v for k, v in sd.items() if k.startswith("layer1.0.")}


# the ResNetSE converter's other entries, for converting one block alone
_BN = {"BatchNorm_0": {"scale": np.ones(1, np.float32), "bias": np.zeros(1, np.float32)}}
_BN_S = {"BatchNorm_0": {"mean": np.zeros(1, np.float32), "var": np.ones(1, np.float32)}}
_DENSE = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
_CONV = {"kernel": np.zeros((1, 1, 1, 1), np.float32), "bias": np.zeros(1, np.float32)}
_STUB = {"conv1": _CONV, "BatchNorm_0": _BN, "BatchNorm_1": _BN, "BatchNorm_2": _BN,
         "BatchNorm_3": _BN, "speaker_embed": {"embedding": np.zeros((1, 1), np.float32)},
         "speaker_proj": _DENSE, "fc1": _DENSE, "fc2": _DENSE,
         **{f"{n}_{lvl}": (_CONV if n == "conv" else _DENSE)
            for n in ("conv", "fc") for lvl in ("low", "mid", "high")}}
_STUB_STATS = {f"BatchNorm_{j}": _BN_S for j in range(4)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("downsample", [False, True], ids=["same", "downsample"])
def test_se_block_matches_jax(no_dropout, train, downsample):
    r = np.random.default_rng(1)
    planes, stride = (16, 2) if downsample else (8, 1)
    x = r.normal(size=(2, 9, 11, 8)).astype(np.float32)       # NHWC
    jm = JR.SEBasicBlock(planes, stride, use_downsample=downsample)
    variables = _init(jm, x)
    want, stats = _apply(jm, variables, x, train=train)
    port = R.SEBasicBlock(8, planes, stride, downsample)
    port.load_state_dict(_se_block_sd(variables), strict=True)
    port.train(train)
    got = port(torch.tensor(x.transpose(0, 3, 1, 2)))
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))
    if train:
        _check_stats(port, _se_block_sd, variables["params"], stats)
    # SELayer alone (its weights from the block's)
    y = r.normal(size=(2, 5, 6, planes)).astype(np.float32)
    se = JR.SELayer(planes)
    got = port.se(torch.tensor(y.transpose(0, 3, 1, 2)))
    want = se.apply({"params": variables["params"]["SELayer_0"]}, jnp.asarray(y))
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def resnet_runs(no_dropout):
    """hop_tpu's full-depth ResNetSE: its variables and its forward in eval and
    training mode."""
    r = np.random.default_rng(2)
    spec = r.normal(size=(B, 128, 70)).astype(np.float32)
    vids = r.integers(0, N_SPEAKERS, size=(B,))
    jm = JR.ResNetSE(n_speakers=N_SPEAKERS, pose_level=3)
    variables = _init(jm, spec, vids)
    runs = {False: _apply(jm, variables, spec, vids)}
    with jax.enable_x64(True):                  # see the docstring
        out, stats = _apply(jm, _cast(variables, np.float64), spec.astype(np.float64),
                            vids, train=True)
        runs[True] = (jax.tree_util.tree_map(np.asarray, out), stats)
    return spec, vids, variables, runs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_se_full_depth_matches_jax(resnet_runs, train):
    spec, vids, variables, runs = resnet_runs
    (weight, f_low, f_mid, f_high, blends), stats = runs[train]
    port = R.ResNetSE(N_SPEAKERS, pose_level=3)
    port.load_state_dict(convert.resnet_se_state_dict_from_jax(variables), strict=True)
    port.train(train)
    got = port(torch.tensor(spec), torch.tensor(vids))
    for g, w, name in zip(got, (weight, f_low, f_mid, f_high), ("weight", "low", "mid", "high")):
        _close(g, w, name)
    assert f_low.shape == (B, 34, 32) and len(got[4]) == 3
    for g, w in zip(got[4], blends):
        _close(g, w, "blend")
    if train:
        _check_stats(port, convert.resnet_se_state_dict_from_jax, variables["params"], stats)
    # without speakers: the taps alone, no blend
    none = port(torch.tensor(spec), None)
    assert none[0] is None and none[4] == []


def test_resnet_se_round_trips_through_hop_tpu_s_importer(resnet_runs):
    variables = resnet_runs[2]
    sd = _np_tree(convert.resnet_se_state_dict_from_jax(variables, "audio_encoder.feat_extractor."))
    back = jimport.convert_resnet_se(sd, "audio_encoder.feat_extractor.")
    _assert_trees_equal(back, variables)


def _stage_inputs(r, pose_dim):
    return (r.normal(size=(B, 34, pose_dim + 1)).astype(np.float32),
            r.integers(0, N_WORDS, size=(B, 34)),
            r.normal(size=(B, 34, 32)).astype(np.float32),
            r.integers(0, N_SPEAKERS, size=(B,)))


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_stage_generators_match_jax(no_dropout, dataset):
    """Every stage of the cascade in training mode, JAX's speaker noise
    handed in; hop_tpu's stages initialised and run under one jit."""
    r = np.random.default_rng(3)
    bones = JH.stage_bones(dataset)
    stages = [JH.HierarchicalPoseGenerator(pose_dim=len(bn) * 3, n_words=N_WORDS,
                                           n_speakers=N_SPEAKERS, hidden_size=HIDDEN,
                                           n_layers=LAYERS) for bn in bones]
    inputs = [_stage_inputs(r, len(bn) * 3) for bn in bones]
    keys = [jax.random.PRNGKey(7 + k) for k in range(len(bones))]

    @jax.jit
    def run(inputs):
        out = []
        for k, (jm, x) in enumerate(zip(stages, inputs)):
            v = jm.init({"params": jax.random.PRNGKey(k), "dropout": keys[k]}, *x,
                        rng=jax.random.PRNGKey(1), train=True)
            out.append((v, jm.apply(v, *x, rng=keys[k], train=True)))
        return out
    for k, (variables, want) in enumerate(run(inputs)):
        variables = jax.tree_util.tree_map(np.asarray, variables)
        sd = convert.pose_generator_state_dict_from_jax(variables)
        back = jimport.convert_hierarchical_generator(_np_tree(sd), LAYERS, LAYERS)
        _assert_trees_equal(back["params"], variables["params"])
        assert back["batch_stats"] == {} and not variables.get("batch_stats")
        port = H.HierarchicalPoseGenerator(len(bones[k]) * 3, N_WORDS, N_SPEAKERS, HIDDEN,
                                           LAYERS)
        port.load_state_dict(sd, strict=True)
        _no_port_dropout(port)
        port.train()
        eps = torch.tensor(np.asarray(jax.random.normal(keys[k], (B, 16))))
        got = port(*(torch.tensor(x) for x in inputs[k]), eps=eps)
        for g, w, name in zip(got, want, ("out", "z", "mu", "logvar")):
            _close(g, w, f"{dataset} stage {k + 1} {name}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_hierarchical_conv_discriminator_matches_jax(no_dropout, dataset, train):
    pose_dim = 27 if dataset == "TED" else 126
    poses = np.random.default_rng(4).normal(size=(B, 34, pose_dim)).astype(np.float32)
    jm = JH.HierarchicalConvDiscriminator()
    variables = _init(jm, poses)
    want, stats = _apply(jm, variables, poses, train=train)
    sd = convert.discriminator_state_dict_from_jax(variables)
    _assert_trees_equal(jimport.convert_conv_discriminator(_np_tree(sd)), variables)
    port = H.HierarchicalConvDiscriminator(pose_dim)
    port.load_state_dict(sd, strict=True)
    _no_port_dropout(port)
    port.train(train)
    _close(port(torch.tensor(poses)), want)
    if train:
        _check_stats(port, convert.discriminator_state_dict_from_jax,
                     variables["params"], stats)


@pytest.mark.parametrize("which", ["hierarchical", "text"])
def test_gru_discriminators_match_jax(no_dropout, which):
    """HierarchicalDiscriminator and the text-conditioned Discriminator,
    training mode (dropout off)."""
    r = np.random.default_rng(5)
    poses = r.normal(size=(B, 34, 27)).astype(np.float32)
    text = r.integers(0, N_WORDS, size=(B, 34))
    if which == "hierarchical":
        jm = JH.HierarchicalDiscriminator(input_size=27, hidden_size=HIDDEN, n_layers=LAYERS)
        port = H.HierarchicalDiscriminator(27, hidden_size=HIDDEN, n_layers=LAYERS)
        args = (poses,)
    else:
        jm = JaxTextDisc(input_size=27, hidden_size=HIDDEN, n_layers=LAYERS, n_words=N_WORDS)
        port = Discriminator(27, hidden_size=HIDDEN, n_layers=LAYERS, n_words=N_WORDS)
        args = (poses, text)
    variables = _init(jm, *args)
    want, _ = _apply(jm, variables, *args, train=True)
    sd = convert.gru_discriminator_state_dict_from_jax(variables)
    back = {"GRU_0": jimport.convert_gru(_np_tree(sd), "gru.", LAYERS, True)}
    _assert_trees_equal(back["GRU_0"], variables["params"]["GRU_0"])
    if which == "text":
        _assert_trees_equal(jimport.convert_text_encoder_tcn(_np_tree(sd), "text_encoder."),
                            variables["params"]["TextEncoderTCN_0"])
    port.load_state_dict(sd, strict=True)
    _no_port_dropout(port)
    port.train()
    got = port(*(torch.tensor(a) for a in args))
    assert got.shape == (B, 1)
    _close(got, want)


def test_text_encoder_matches_jax(no_dropout):
    tokens = np.random.default_rng(6).integers(0, N_WORDS, size=(B, 34))
    jm = JH.HierarchicalTextEncoder(n_words=N_WORDS, hidden_size=HIDDEN, n_layers=LAYERS)
    variables = _init(jm, tokens)
    want, _ = _apply(jm, variables, tokens, train=True)
    port = H.HierarchicalTextEncoder(N_WORDS, HIDDEN, LAYERS)
    sd = {}
    convert._text_encoder_tcn(sd, "", variables["params"]["TextEncoderTCN_0"])
    port.load_state_dict(sd, strict=True)
    _no_port_dropout(port)
    port.train()
    _close(port(torch.tensor(tokens)), want)


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_route_pre_seq_is_jax_s_bitwise(dataset):
    """Every transition of the cascade, the Expressive off-by-one tail
    included (the first face-bone x stays 0, the indicator column takes
    the last face bone's z)."""
    r = np.random.default_rng(7)
    bones = H.stage_bones(dataset)
    tail = H.routing_tail(dataset)
    assert tail == JH.routing_tail(dataset)
    pose_dim = 27 if dataset == "TED" else 126
    target = r.normal(size=(2, 34, pose_dim)).astype(np.float32)
    prev, prev_bones = None, None
    for k, bn in enumerate(bones):
        np.testing.assert_array_equal(H.bone_slice_indices(bn), JH.bone_slice_indices(bn))
        tk = H.slice_target(torch.tensor(target), bn)
        want_tk = np.asarray(JH.slice_target(jnp.asarray(target), bn))
        np.testing.assert_array_equal(tk.numpy(), want_tk)
        want = np.asarray(JH.route_pre_seq(jnp.asarray(want_tk),
                                           None if prev is None else jnp.asarray(prev),
                                           bn, prev_bones, 4, tail_bones=tail))
        got = H.route_pre_seq(tk, None if prev is None else torch.tensor(prev), bn,
                              prev_bones, 4, tail_bones=tail)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"stage {k + 1}")
        if prev is not None and tail:
            assert np.all(want[:, 4:, (len(bn) - tail) * 3] == 0)
            np.testing.assert_array_equal(want[:, 4:, -1], prev[:, 4:, -1])
        prev = r.normal(size=(2, 34, len(bn) * 3)).astype(np.float32)
        prev_bones = bn


def test_stage_tables_and_angle_statistics_equal():
    assert H.TED_STAGE_BONES == JH.TED_STAGE_BONES
    assert H.EXPRESSIVE_STAGE_BONES == JH.EXPRESSIVE_STAGE_BONES
    assert H.TED_AVG_ANGLE == JH.TED_AVG_ANGLE and H.TED_VAR_ANGLE == JH.TED_VAR_ANGLE
    assert hx.AVG_ANGLE == jhx.AVG_ANGLE and hx.VAR_ANGLE == jhx.VAR_ANGLE
    for dataset in ("TED", "TED_expressive"):
        assert H.stage_bones(dataset) == JH.stage_bones(dataset)
