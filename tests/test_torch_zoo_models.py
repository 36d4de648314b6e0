"""The baseline zoo's modules in the port against hop_tpu's, forward in f32,
eval mode, at tiny_test_config (hidden 32, 2 layers), inputs from a numpy
seed: GRUCell, the Conv1d + BatchNorm + LeakyReLU element, WavEncoder,
TextEncoderTCN, the trimodal PoseGenerator (every input_context, both GRU
routes), Seq2SeqNet, speech2gesture's Generator and Discriminator, and the
embedding nets' PoseDecoderFC, PoseDecoderGRU, ContextEncoder and
EmbeddingNet in joint-embedding mode. Tolerance: 1e-5, relative and
absolute (f32 round-off through at most a few dozen layers; JAX runs at
"highest" matmul precision, conftest.py). BatchNorm statistics are set away
from (0, 1) so that eval mode's use of them shows. The speaker latent and
the context latent draw noise at inference in both packages: both get the
same `eps`, JAX's draw.

Weights cross from JAX to the port through `hop_tpu_torch.convert`'s
`*_state_dict_from_jax`; where hop_tpu has an importer
(`convert_pose_generator`, `convert_seq2seq`, `convert_s2g_generator`,
`convert_s2g_discriminator`) the round trip JAX -> port -> importer -> JAX
is bitwise. ContextEncoder and PoseDecoderGRU have no importer, so that
net is checked in the JAX -> port direction only.
"""


import jax
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from hop_tpu.config import tiny_test_config as jax_tiny
from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.eval import torch_import_generator as importers
from hop_tpu.models import common as jcommon
from hop_tpu.models import embedding_net as jemb
from hop_tpu.models import speech2gesture as js2g
from hop_tpu.models.multimodal_context import PoseGenerator as JaxPoseGenerator
from hop_tpu.models.seq2seq import Seq2SeqNet as JaxSeq2Seq
from hop_tpu.models.tcn import TextEncoderTCN as JaxTCN
from hop_tpu.ops.gru import GRUCell as JaxGRUCell
from hop_tpu.utils.params import set_pretrained_embeddings as jax_set_embeddings

from hop_tpu_torch import convert
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models import common, embedding_net, speech2gesture
from hop_tpu_torch.models.multimodal_context import PoseGenerator
from hop_tpu_torch.models.seq2seq import Seq2SeqNet
from hop_tpu_torch.models.tcn import TextEncoderTCN
from hop_tpu_torch.ops.gru import GRUCell
from hop_tpu_torch.utils.params import set_pretrained_embeddings

from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

B = 4
N_WORDS = 50
N_SPEAKERS = 10
TOL = 1e-5
CFG = tiny_test_config("TED")
HIDDEN, LAYERS = CFG.baseline.hidden_size, CFG.baseline.n_layers


@pytest.fixture(scope="module")
def batch():
    cfg = jax_tiny("TED")
    b = jsynthetic.add_device_features(jsynthetic.make_batch(cfg, B, seed=0), cfg)
    b = {k: np.asarray(v) for k, v in b.items() if not isinstance(v, dict)}
    b["text_padded"] = b["text_padded"] % N_WORDS
    b["word_seq"] = b["word_seq"] % N_WORDS
    b["text_mask"] = (np.arange(b["word_seq"].shape[1])[None]
                      < b["text_lengths"][:, None]).astype(np.float32)
    b["text_mask"][0, 3:] = 0.0          # a sample with few words
    b["vid_indices"] = b["vid_indices"] % N_SPEAKERS
    return b


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, flax_meta.unbox(tree))


def _jit(fn, *args, **kw):
    """fn(*args, **kw) under jit, the arrays among args traced, the rest
    static: op by op, flax's init of a conv net takes several times as long
    on the CPU."""
    arrays = [i for i, a in enumerate(args)
              if isinstance(a, (np.ndarray, jax.Array, dict))]

    def call(*traced):
        full = list(args)
        for i, a in zip(arrays, traced):
            full[i] = a
        return fn(*full, **kw)
    return jax.jit(call)(*(args[i] for i in arrays))


def _init(module, *args, seed=0, **kw):
    """Variables (numpy leaves), BatchNorm statistics drawn away from (0, 1)."""
    key = jax.random.PRNGKey(seed)
    variables = _numpy(_jit(lambda *a, **k: module.init(
        {"params": key, "dropout": key}, *a, **k), *args, **kw))
    r = np.random.default_rng(seed + 100)
    for bn in jax.tree_util.tree_leaves(
            variables.get("batch_stats", {}),
            is_leaf=lambda t: isinstance(t, dict) and "mean" in t):
        bn["mean"] = r.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return variables


def _apply(module, variables, *args, **kw):
    return _jit(lambda v, *a, **k: module.apply(v, *a, **k),
                variables, *args, **kw)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _bitwise(tree_a, tree_b):
    flat_a = jax.tree_util.tree_flatten_with_path(tree_a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(tree_b)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


def test_gru_cell_matches_jax():
    r = np.random.default_rng(1)
    x = r.normal(size=(B, 12)).astype(np.float32)
    h = r.normal(size=(B, 20)).astype(np.float32)
    cell = JaxGRUCell(20)
    variables = _init(cell, x, h)
    want = _apply(cell, variables, x, h)
    port = GRUCell(12, 20)
    p = variables["params"]
    _load(port, {f"{n}_l0".replace("w_", "weight_").replace("b_", "bias_"): _t(v)
                 for n, v in p.items()})
    _close(port(_t(x), _t(h)[None])[0], want)


@pytest.mark.parametrize("padding,stride", [(0, 1), (3, 2)])
def test_conv1d_bn_leaky_matches_jax(padding, stride):
    x = np.random.default_rng(2).normal(size=(B, 30, 6)).astype(np.float32)
    block = jcommon.Conv1dBNLeaky(10, 5, stride, padding, slope=0.2)
    variables = _init(block, x)
    want = _apply(block, variables, x, False)
    port = torch.nn.Sequential(*common.conv1d_bn_leaky(6, 10, 5, stride, padding, 0.2))
    sd = {}
    convert._conv1d(sd, "0", variables["params"]["Conv_0"])
    convert._bn_of(sd, "1", variables["params"], variables["batch_stats"], "BatchNorm_0")
    _close(_load(port, sd)(_t(x).transpose(1, 2)).transpose(1, 2), want)


def test_wav_encoder_matches_jax(batch):
    enc = jcommon.WavEncoder()
    variables = _init(enc, batch["in_audio"])
    want = _apply(enc, variables, batch["in_audio"], False)
    sd = {}
    convert._wav_encoder(sd, "", variables["params"], variables["batch_stats"])
    got = _load(common.WavEncoder(), sd)(_t(batch["in_audio"]))
    assert got.shape == (B, 34, 32)
    _close(got, want)


def test_text_encoder_tcn_matches_jax(batch):
    tcn = JaxTCN(n_words=N_WORDS, embed_size=300, num_channels=(HIDDEN,) * 3)
    variables = _init(tcn, batch["text_padded"])
    want = _apply(tcn, variables, batch["text_padded"], False)
    sd = {}
    convert._text_encoder_tcn(sd, "", variables["params"])
    port = _load(TextEncoderTCN(N_WORDS, 300, (HIDDEN,) * 3), sd)
    _close(port(_t(batch["text_padded"])), want)


@pytest.fixture(scope="module")
def pose_generators(batch):
    """input_context -> (args, eps, JAX's variables and outputs), made once
    for both GRU routes."""
    pre = np.zeros((B, 34, 28), np.float32)
    pre[:, :4, :27] = batch["target_vec"][:, :4]
    pre[:, :4, 27] = 1.0
    key = jax.random.PRNGKey(5)
    args = (pre, batch["text_padded"], batch["in_audio"], batch["vid_indices"])
    eps = _t(jax.random.normal(key, (B, 16)))
    made = {}

    def get(input_context):
        if input_context not in made:
            gen = JaxPoseGenerator(pose_dim=27, n_words=N_WORDS, n_speakers=N_SPEAKERS,
                                   hidden_size=HIDDEN, n_layers=LAYERS,
                                   input_context=input_context)
            variables = _init(gen, *args, rng=key, train=False)
            made[input_context] = (args, eps, variables,
                                   _apply(gen, variables, *args, rng=key, train=False))
        return made[input_context]
    return get


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
@pytest.mark.parametrize("input_context", ["both", "audio", "text", "none"])
def test_pose_generator_matches_jax(pose_generators, input_context, gru_kernel):
    args, eps, variables, want = pose_generators(input_context)
    port = _load(PoseGenerator(27, N_WORDS, N_SPEAKERS, HIDDEN, LAYERS,
                               input_context=input_context, gru_kernel=gru_kernel),
                 convert.pose_generator_state_dict_from_jax(variables))
    got = port(*(_t(a) for a in args), eps=eps)
    for g, w in zip(got, want):          # poses, z, mu, logvar
        _close(g, w)


def test_pose_generator_round_trip_through_the_importer(batch):
    """hop_tpu's importer reads a 4-level TCN (its default), so this net has 4
    layers."""
    gen = JaxPoseGenerator(pose_dim=27, n_words=N_WORDS, n_speakers=N_SPEAKERS,
                           hidden_size=16, n_layers=4)
    pre = np.zeros((B, 34, 28), np.float32)
    variables = _init(gen, pre, batch["text_padded"], batch["in_audio"],
                      batch["vid_indices"], rng=jax.random.PRNGKey(1), train=False)
    sd = convert.pose_generator_state_dict_from_jax(variables)
    port = _load(PoseGenerator(27, N_WORDS, N_SPEAKERS, 16, 4), sd)
    back = importers.convert_pose_generator(
        {k: v.numpy() for k, v in port.state_dict().items()}, n_layers=4)
    _bitwise(back, variables)


@pytest.fixture(scope="module")
def seq2seq(batch):
    net = JaxSeq2Seq(pose_dim=27, n_frames=34, n_pre_poses=4, n_words=N_WORDS,
                     embed_size=300, hidden_size=HIDDEN, n_layers=LAYERS)
    args = (batch["word_seq"], batch["text_mask"], batch["target_vec"])
    variables = _init(net, *args, train=False)
    return args, variables, _apply(net, variables, *args, train=False)


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
def test_seq2seq_matches_jax(batch, seq2seq, gru_kernel):
    args, variables, want = seq2seq
    port = _load(Seq2SeqNet(27, 34, 4, N_WORDS, 300, HIDDEN, LAYERS,
                            gru_kernel=gru_kernel),
                 convert.seq2seq_state_dict_from_jax(variables))
    got = port(*(_t(a) for a in args))
    assert got.shape == (B, 34, 27)
    _close(got, want)
    torch.testing.assert_close(got[:, 0], _t(batch["target_vec"][:, 0]), rtol=0, atol=0)


def test_seq2seq_round_trip_through_the_importer(seq2seq):
    variables = seq2seq[1]
    port = _load(Seq2SeqNet(27, 34, 4, N_WORDS, 300, HIDDEN, LAYERS),
                 convert.seq2seq_state_dict_from_jax(variables))
    back = importers.convert_seq2seq({k: v.numpy() for k, v in port.state_dict().items()},
                                     n_layers=LAYERS)
    _bitwise(back, variables)


@pytest.fixture(scope="module")
def s2g(batch):
    gen = js2g.Generator(n_poses=34, pose_dim=27, n_pre_poses=4)
    dis = js2g.Discriminator(pose_dim=27)
    gen_vars = _init(gen, batch["spectrogram"], batch["target_vec"][:, :4], train=False)
    dis_vars = _init(dis, batch["target_vec"], train=False, seed=1)
    return gen, dis, gen_vars, dis_vars


def test_s2g_generator_and_discriminator_match_jax(batch, s2g):
    gen, dis, gen_vars, dis_vars = s2g
    want = _apply(gen, gen_vars, batch["spectrogram"], batch["target_vec"][:, :4], False)
    port_gen = _load(speech2gesture.Generator(34, 27, 4),
                     convert.s2g_generator_state_dict_from_jax(gen_vars))
    got = port_gen(_t(batch["spectrogram"]), _t(batch["target_vec"][:, :4]))
    assert got.shape == (B, 34, 27)
    _close(got, want)
    motion = batch["target_vec"][:, 1:] - batch["target_vec"][:, :-1]
    want_d = _apply(dis, dis_vars, motion, False)
    port_dis = _load(speech2gesture.Discriminator(27),
                     convert.s2g_discriminator_state_dict_from_jax(dis_vars))
    _close(port_dis(_t(motion)), want_d)


def test_s2g_round_trips_through_the_importers(s2g):
    _, _, gen_vars, dis_vars = s2g
    for variables, to_port, net, importer in (
            (gen_vars, convert.s2g_generator_state_dict_from_jax,
             speech2gesture.Generator(34, 27, 4), importers.convert_s2g_generator),
            (dis_vars, convert.s2g_discriminator_state_dict_from_jax,
             speech2gesture.Discriminator(27), importers.convert_s2g_discriminator)):
        port = _load(net, to_port(variables))
        _bitwise(importer({k: v.numpy() for k, v in port.state_dict().items()}),
                 variables)


def _fc_state_dict(variables, use_pre_poses):
    p, s, sd = variables["params"], variables["batch_stats"], {}
    dense = 0
    if use_pre_poses:
        convert._lin(sd, "pre_pose_net.0", p["Dense_0"])
        convert._bn_of(sd, "pre_pose_net.1", p, s, "BatchNorm_0")
        convert._lin(sd, "pre_pose_net.3", p["Dense_1"])
        dense = 2
    for j in range(4):
        bn = j + (1 if use_pre_poses else 0)
        convert._lin(sd, f"net.{3 * j}", p[f"Dense_{dense + j}"])
        convert._bn_of(sd, f"net.{3 * j + 1}", p, s, f"BatchNorm_{bn}")
    convert._lin(sd, "net.12", p[f"Dense_{dense + 4}"])
    return sd


@pytest.mark.parametrize("use_pre_poses", [False, True])
def test_pose_decoder_fc_matches_jax(batch, use_pre_poses):
    latent = np.random.default_rng(3).normal(size=(B, 32)).astype(np.float32)
    pre = batch["target_vec"][:, :4]
    dec = jemb.PoseDecoderFC(gen_length=34, pose_dim=27, use_pre_poses=use_pre_poses)
    variables = _init(dec, latent, pre)
    want = _apply(dec, variables, latent, pre, False)
    port = _load(embedding_net.PoseDecoderFC(34, 27, use_pre_poses=use_pre_poses),
                 _fc_state_dict(variables, use_pre_poses))
    _close(port(_t(latent), _t(pre)), want)


@pytest.fixture(scope="module")
def joint(batch):
    net = jemb.EmbeddingNet(pose_dim=27, n_frames=34, n_words=N_WORDS, mode="random")
    key = jax.random.PRNGKey(9)
    args = (batch["text_padded"], batch["in_audio"], batch["target_vec"][:, :4],
            batch["target_vec"])
    variables = _init(net, *args, rng=key, train=False)
    outputs = {mode: _apply(net, variables, *args, input_mode=mode, rng=key, train=False)
               for mode in JOINT_MODES}
    return args, key, variables, outputs


JOINT_MODES = ("pose", "speech")


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
@pytest.mark.parametrize("input_mode", JOINT_MODES)
def test_joint_embedding_net_matches_jax(joint, input_mode, gru_kernel):
    """EmbeddingNet in joint-embedding mode: ContextEncoder, PoseEncoderConv
    and PoseDecoderGRU, decoding from the poses' or the speech's latent
    (the context latent's noise handed in, JAX's draw)."""
    args, key, variables, outputs = joint
    want = outputs[input_mode]
    port = _load(embedding_net.EmbeddingNet(27, 34, N_WORDS, "random",
                                            gru_kernel=gru_kernel),
                 convert.embedding_net_state_dict_from_jax(variables))
    eps = _t(jax.random.normal(key, (B, 32)))
    got = port(*(_t(a) for a in args), input_mode=input_mode, eps=eps)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        _close(g, w)


def test_set_pretrained_embeddings_matches_jax(pose_generators):
    """The vocabulary's vectors go into every table shaped like them (the
    text encoder's), not the speaker table."""
    variables = pose_generators("both")[2]
    vectors = np.random.default_rng(4).normal(size=(N_WORDS, 300)).astype(np.float32)
    want, n_jax = jax_set_embeddings(variables, vectors)
    port = _load(PoseGenerator(27, N_WORDS, N_SPEAKERS, HIDDEN, LAYERS),
                 convert.pose_generator_state_dict_from_jax(variables))
    assert set_pretrained_embeddings(port, vectors) == n_jax == 1
    want_sd = convert.pose_generator_state_dict_from_jax(_numpy(want))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want_sd[k], rtol=0, atol=0, msg=k)


def test_word_embedding_gradient_is_the_lookups():
    """`common.WordEmbedding`'s ordered backward gives nn.Embedding's weight
    gradient (the sum of each id's rows), repeated ids and unused rows
    included, and its forward is the lookup."""
    torch.manual_seed(0)
    ours, ref = common.WordEmbedding(N_WORDS, 16), torch.nn.Embedding(N_WORDS, 16)
    ref.load_state_dict(ours.state_dict())
    ids = torch.randint(0, N_WORDS // 2, (B, 34))
    g = torch.randn(B, 34, 16)
    out = ours(ids)
    torch.testing.assert_close(out, ref(ids), rtol=0, atol=0)
    out.backward(g)
    ref(ids).backward(g)
    torch.testing.assert_close(ours.weight.grad, ref.weight.grad, rtol=0, atol=1e-6)
    assert not ours.weight.grad[N_WORDS // 2:].any()


@pytest.mark.parametrize("n_in,width", [(14, 5), (14, 1), (3, 70), (50, 9)])
def test_linear_resize_is_torchs_interpolate(n_in, width):
    """speech2gesture's resize to (34, 1) by its weight products is torch's
    bilinear interpolate (align_corners=False; up, down and to one column)."""
    x = torch.randn(2, 3, n_in, width, generator=torch.Generator().manual_seed(n_in))
    want = torch.nn.functional.interpolate(x, size=(34, 1), mode="bilinear",
                                           align_corners=False)[..., 0]
    got = torch.einsum("oh,bchw,w->bco", speech2gesture.linear_resize_weights(n_in, 34), x,
                       speech2gesture.linear_resize_weights(width, 1)[0])
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
