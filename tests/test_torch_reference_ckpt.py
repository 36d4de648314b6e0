"""Reference-format checkpoints: the port's `eval.torch_export_hop` and
`eval.torch_import` against hop_tpu's exporter and importers.

Every `.bin` here is fabricated in the test, as the reference's
`torch.save` dicts are made: the state dicts under 'generator', 'gen_dict'
or 'motion_ae', beside pickled objects of the reference's own code (its
`args` namespace, its `lang_model` Vocab, stood in for by a class of this
module) that the port's reader must not need. Forwards agree to 1e-5
(f32 round-off through ~20 layers, as tests/test_torch_export.py); weights
that only move between files are compared bitwise.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta

from hop_tpu.eval.torch_export_hop import export_hop_state_dict as jax_export_hop_state_dict
from hop_tpu.eval.torch_import import convert_embedding_net_pose, convert_motion_ae
from hop_tpu.eval.torch_import_generator import convert_pose_generator
from hop_tpu.eval.torch_import_hop import convert_hop_model
from hop_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from hop_tpu.models.motion_ae import MotionAE as JaxMotionAE

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.convert import pose_generator_state_dict_from_jax, state_dict_from_jax
from hop_tpu_torch.eval import torch_export_hop
from hop_tpu_torch.eval.torch_import import Opaque, load_reference, load_torch_checkpoint
from hop_tpu_torch.models.embedding_net import EmbeddingNet
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.models.multimodal_context import build_pose_generator
from test_torch_hop_model import N_SPEAKERS, _f32, _jax_model, _port_model
from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)

FWD_TOL = 1e-5


class Vocab:
    """Stands in for the reference's utils.vocab.Vocab in a payload."""

    def __init__(self):
        self.word2index = {"hello": 4}


def _save_reference(path, **payload):
    torch.save({**payload, "lang_model": Vocab(), "epoch": 7,
                "args": argparse.Namespace(model="HOP")}, path)


def _inputs(cfg, B, seed):
    r = np.random.default_rng(seed)
    d = cfg.data
    return (r.normal(size=(B, d.expected_audio_length)).astype(np.float32),
            r.normal(size=(B, d.n_poses, d.mel_bins)).astype(np.float32),
            r.integers(0, cfg.llm.vocab_size, size=(B, d.n_poses)).astype(np.int32),
            r.normal(size=(B, d.n_seed_frames, d.pose_dim)).astype(np.float32),
            r.integers(0, N_SPEAKERS, size=(B,)).astype(np.int32),
            r.normal(size=(B, cfg.hop.z_size)).astype(np.float32))


def _port_forward(model, inputs):
    t = [torch.from_numpy(a) for a in inputs]
    t[2], t[4] = t[2].long(), t[4].long()
    with torch.inference_mode():
        return model(*t[:5], eps=t[5])[0].numpy()


def _jax_forward(jmodel, variables, inputs):
    """hop_tpu's forward with the given speaker noise: `reparameterize` reads
    it from a stub of jax.random.normal."""
    eps = jnp.asarray(inputs[5])
    normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: eps.astype(dtype)
    try:
        out = jax.jit(lambda v, *a: jmodel.apply(v, *a, rng=jax.random.PRNGKey(0),
                                                 train=False)[0])(
            variables, *map(jnp.asarray, inputs[:5]))
    finally:
        jax.random.normal = normal
    return np.asarray(out)


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", "interpret-fused")


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_hop_tpu_reads_the_ports_generator_bin(tmp_path, dataset):
    """The port's `.bin` ({'generator': ...}, no backbone) read by hop_tpu's
    `convert_hop_model`, the backbone added as the reference's
    from_pretrained would have it: the same variables, and the same forward."""
    jcfg_, jmodel, variables = _jax_model(dataset, seed=0)
    model = _port_model(dataset, variables)
    sd = torch_export_hop.export_hop_state_dict(model, model.cfg)
    assert sd and not any(k.startswith("llm_model.") for k in sd)
    torch.save({"generator": sd}, tmp_path / "g.bin")
    payload = torch.load(tmp_path / "g.bin")["generator"]
    backbone = {k: v for k, v in model.state_dict().items() if k.startswith("llm_model.")}
    back = convert_hop_model({k: v.numpy() for k, v in {**payload, **backbone}.items()}, jcfg_)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf), err_msg=str(path))
    inputs = _inputs(jcfg_, 2, seed=1)
    np.testing.assert_allclose(_jax_forward(jmodel, back, inputs),
                               _port_forward(model, inputs), rtol=0, atol=FWD_TOL)


def test_port_reads_hop_tpus_generator_bin(tmp_path):
    """hop_tpu's exporter's `.bin` (its `main`'s payload) beside a pickled
    Vocab and args, read by `load_torch_checkpoint` and loaded by
    `load_reference` into a model of another seed: every exported tensor
    arrives bitwise, the backbone stays the model's, and the forward is
    hop_tpu's."""
    jcfg_, jmodel, variables = _jax_model("TED", seed=0)
    sd = jax_export_hop_state_dict(variables, jcfg_)
    _save_reference(tmp_path / "h.bin", generator={k: torch.tensor(v) for k, v in sd.items()})
    payload = load_torch_checkpoint(str(tmp_path / "h.bin"))
    assert isinstance(payload["lang_model"], Opaque) and payload["epoch"] == 7
    assert payload["lang_model"].state == {"word2index": {"hello": 4}}
    cfg = _f32(tcfg.tiny_test_config("TED"))
    torch.manual_seed(5)
    model = HOPModel(cfg, N_SPEAKERS)
    # the backbone the reference builds with from_pretrained
    want = state_dict_from_jax(variables, cfg)
    model.llm_model.load_state_dict({k[len("llm_model."):]: v for k, v in want.items()
                                     if k.startswith("llm_model.")})
    assert load_reference(model, payload, "generator") == []
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    inputs = _inputs(jcfg_, 2, seed=2)
    np.testing.assert_allclose(_port_forward(model, inputs),
                               _jax_forward(jmodel, variables, inputs), rtol=0, atol=FWD_TOL)


def test_generator_key_check_names_what_is_wrong(tmp_path):
    cfg = tcfg.tiny_test_config("TED")
    model = HOPModel(cfg, N_SPEAKERS)
    sd = torch_export_hop.export_hop_state_dict(model, cfg)
    # what the reference holds and the port does not build is ignored
    extras = {"audio_encoder.feat_extractor.0.weight": torch.zeros(3),
              "gwnet.residual_convs.0.weight": torch.zeros(2),
              "llm_model.pooler.dense.weight": torch.zeros(2),
              "llm_model.embeddings.position_ids": torch.arange(4)}
    assert load_reference(model, {"generator": {**sd, **extras}}, "generator") == sorted(extras)
    del sd["gru.weight_ih_l0"]
    sd["gru.weight_ih_l9"] = torch.zeros(1)
    with pytest.raises(KeyError, match=r"missing \['gru.weight_ih_l0'\], unexpected "
                                       r"\['gru.weight_ih_l9'\]"):
        load_reference(model, {"generator": sd}, "generator")
    with pytest.raises(KeyError, match="no 'motion_ae'"):
        load_reference(model, {"generator": sd}, "motion_ae")


def _fabricated(module, seed):
    """The module's state dict with seeded values (running variances kept
    positive), as a trained reference net's."""
    r = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        if v.dtype != torch.float32:
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy(r.uniform(0.5, 2.0, v.shape).astype(np.float32))
        else:
            out[k] = torch.from_numpy((r.normal(0, 0.2, v.shape)).astype(np.float32))
    return out


def _tree_np(variables):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), variables)


def test_feature_nets_read_one_fabricated_payload(tmp_path):
    """One `.bin` with 'gen_dict' (the TED FGD net, EmbeddingNet in pose
    mode) and 'motion_ae' (Expressive's): the port's loader and hop_tpu's
    importers give the same features."""
    ted_sd = _fabricated(EmbeddingNet(27, 34, 10), seed=1)
    expr_sd = _fabricated(MotionAE(126, 16), seed=2)
    _save_reference(tmp_path / "f.bin", gen_dict=ted_sd, motion_ae=expr_sd)
    payload = load_torch_checkpoint(str(tmp_path / "f.bin"))
    net, ae = EmbeddingNet(27, 34, 10).eval(), MotionAE(126, 16).eval()
    assert load_reference(net, payload, "gen_dict") == []
    assert load_reference(ae, payload, "motion_ae") == []

    poses = np.random.default_rng(3).normal(size=(3, 34, 27)).astype(np.float32)
    jnet = JaxEmbeddingNet(pose_dim=27, n_frames=34, n_words=10, mode="pose")
    jv = _tree_np(convert_embedding_net_pose({k: v.numpy() for k, v in ted_sd.items()}))
    want = jnet.apply(jv, None, None, jnp.asarray(poses[:, :4]), jnp.asarray(poses),
                      input_mode="pose", train=False)
    with torch.no_grad():
        got = net(None, None, None, torch.from_numpy(poses))
    for i in (3, 4, 5, 6):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0,
                                   atol=FWD_TOL, err_msg=str(i))

    poses = np.random.default_rng(4).normal(size=(2, 34, 126)).astype(np.float32)
    jae = JaxMotionAE(pose_dim=126, latent_dim=16)
    jv = _tree_np(convert_motion_ae({k: v.numpy() for k, v in expr_sd.items()}))
    jr, jz = jae.apply(jv, jnp.asarray(poses), False)
    with torch.no_grad():
        tr, tz = ae(torch.from_numpy(poses))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=FWD_TOL)


def test_pose_generator_gen_dict(tmp_path):
    """'gen_dict' of the multimodal-context baseline into the port's
    PoseGenerator, bitwise; hop_tpu's `convert_pose_generator` reads the same
    payload into the variables the port's converter maps back to it."""
    cfg = tcfg.tiny_test_config("TED")
    cfg = cfg.replace(baseline=dataclasses.replace(cfg.baseline, n_layers=4))
    sd = build_pose_generator(cfg, 20, N_SPEAKERS, seed=1, device="cpu").state_dict()
    _save_reference(tmp_path / "p.bin", gen_dict=sd)
    payload = load_torch_checkpoint(str(tmp_path / "p.bin"))
    gen = build_pose_generator(cfg, 20, N_SPEAKERS, seed=2, device="cpu")
    assert load_reference(gen, payload, "gen_dict") == []
    for k, v in gen.state_dict().items():
        assert torch.equal(v, sd[k]), k
    variables = convert_pose_generator({k: v.numpy() for k, v in payload["gen_dict"].items()})
    back = pose_generator_state_dict_from_jax(flax_meta.unbox(variables))
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="HOPModel"):
        load_reference(HOPModel(cfg, N_SPEAKERS), payload, "gen_dict")
