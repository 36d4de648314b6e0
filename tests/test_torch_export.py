"""The registered operators and the serving export (hop_tpu_torch.infer,
cli.export_model) on the CPU, against hop_tpu.

Each registered operator `torch.ops.hop_tpu_torch.*` is, on CPU tensors,
its kernel's plain version (bitwise), agrees with the Pallas kernel in
interpret mode (as the JAX package's own tests run it) to 1e-5 on inputs
of O(1), and its fake implementation gives the real output's shape, dtype
and strides. The port's loaded artifact agrees with hop_tpu's
(`hop_tpu.infer.load_exported(export_forward(..., platforms=("cpu",)))`)
at `tiny_test_config` for TED and TED_expressive, with the weights carried
by `convert.state_dict_from_jax` and the speaker noise JAX draws from the
artifact's key handed in as eps, to 1e-5 (f32 round-off through ~20
layers; measured 7e-7 and 9e-7), and the port's own eager forward bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.infer import export_forward as jax_export_forward
from hop_tpu.infer import load_exported as jax_load_exported
from hop_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from hop_tpu.ops.pallas_block_attention import block_attention as jax_block_attention
from hop_tpu.ops.pallas_gru_fused import gru_fused_layer as jax_gru_fused_layer
from hop_tpu.ops.pallas_gru_stack import gru_stack as jax_gru_stack
from hop_tpu.ops.pallas_reprogramming import fused_reprogramming_attention

from hop_tpu_torch import config as tcfg
from hop_tpu_torch import infer
from hop_tpu_torch.cli import export_model, run_ted
from hop_tpu_torch.data.synthetic import WordIndex, make_clip
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.ops import attention as K4
from hop_tpu_torch.ops import block_attention as K5
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_stack as K3
from hop_tpu_torch.ops import reprogramming_attention as K1
from test_torch_hop_model import N_SPEAKERS, _jax_model, _port_model
from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
JAX_TOL = 1e-5
ROUTES = [("fused", "plain"), ("stack", "fused"), ("stack", "block")]


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", "interpret-fused")
    monkeypatch.setenv("HOP_TPU_PALLAS_ATTN", "interpret")
    monkeypatch.setenv("HOP_TPU_PALLAS_BLOCK_ATTN", "interpret")


def _arr(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _op_case(name):
    """(torch args, the Pallas kernel's result, the plain version's)."""
    r = np.random.default_rng(len(name))
    seed0 = jnp.asarray([0], jnp.int32)
    if name == "reprogramming_attention_fwd":
        q, k, v = _arr(r, 3, 34, 4, 16), _arr(r, 4, 65, 16), _arr(r, 4, 65, 16)
        args = (*map(torch.from_numpy, (q, k, v)), 0.25, 0.0, 0)
        want = fused_reprogramming_attention(*map(jnp.asarray, (q, k, v)), seed0, 0.25, 0.0)
        return args, want, K1.plain_reprogramming_attention(*args)
    if name in ("fused_attention_fwd", "block_attention_fwd"):
        q, k, v = (_arr(r, 3, 34, 2, 64) for _ in range(3))
        args = (*map(torch.from_numpy, (q, k, v)), 0.125, 0.0, 0)
        jfn, plain = ((jax_fused_attention, K4.plain_fused_attention)
                      if name == "fused_attention_fwd"
                      else (jax_block_attention, K5.plain_block_attention))
        return args, jfn(*map(jnp.asarray, (q, k, v)), seed0, 0.125, 0.0), plain(*args)
    T, B, I, H, D = 7, 4, 12, 16, 2
    w = (_arr(r, D, 3, I, H, scale=0.3), _arr(r, D, 3, 1, H, scale=0.3),
         _arr(r, D, 3, H, H, scale=0.3), _arr(r, D, 3, 1, H, scale=0.3))
    h0 = _arr(r, B, H, scale=0.3)
    x = _arr(r, T, B, I, scale=0.3)
    if name == "gru_fused_layer_fwd":
        args = tuple(map(torch.from_numpy, (x, *w, h0)))
        want = jax_gru_fused_layer(*map(jnp.asarray, (x, *w, h0)), True)
        return args, want, K2.plain_gru_fused_layer(*args)
    # the stack route's gate streams: strided views of one (T, B, D, 3, H) product
    proj = torch.from_numpy(_arr(r, T, B, D, 3, H))
    streams = tuple(g.permute(2, 0, 1, 3) for g in proj.unbind(dim=3))
    args = (*streams, *map(torch.from_numpy, (w[2], w[3], h0)))
    want = jax_gru_stack(*(jnp.asarray(s.contiguous().numpy()) for s in streams),
                         *map(jnp.asarray, (w[2], w[3], h0)), True)
    return args, want, K3.plain_gru_stack(*args)


OPS = ["reprogramming_attention_fwd", "gru_fused_layer_fwd", "gru_stack_fwd",
       "fused_attention_fwd", "block_attention_fwd"]


@pytest.mark.parametrize("name", OPS)
def test_registered_op_is_the_plain_version_and_matches_pallas(name):
    args, want, plain = _op_case(name)
    op = getattr(torch.ops.hop_tpu_torch, name)
    got = op(*args)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=OP_TOL)
    with torch._subclasses.fake_tensor.FakeTensorMode():
        fake = op(*(torch.empty_strided(a.shape, a.stride(), dtype=a.dtype)
                    if isinstance(a, torch.Tensor) else a for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (got.shape, got.dtype, got.stride())
    # a meta tensor gets the shape, and never reaches a kernel's launch
    meta = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
    assert meta.device.type == "meta" and meta.shape == got.shape
    torch.library.opcheck(op.default, args)


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_loaded_artifact_matches_jax_and_eager(dataset):
    jcfg_, jmodel, variables = _jax_model(dataset, seed=0)
    model = _port_model(dataset, variables)
    d, B = jcfg_.data, 1
    r = np.random.default_rng(3)
    alen = int(d.n_poses / d.pose_resampling_fps * d.sample_rate)
    inputs = (_arr(r, B, alen), _arr(r, B, d.n_poses, d.mel_bins),
              r.integers(0, jcfg_.llm.vocab_size, size=(B, d.n_poses)).astype(np.int32),
              _arr(r, B, d.n_seed_frames, d.pose_dim),
              r.integers(0, N_SPEAKERS, size=(B,)).astype(np.int32))
    key = jax.random.PRNGKey(9)
    call = jax_load_exported(jax_export_forward(jmodel, variables, jcfg_, batch_size=B,
                                                platforms=("cpu",)))
    want = np.asarray(call(variables, *inputs, jax.random.key_data(key).astype(jnp.uint32)))
    # the speaker noise the JAX SpeakerLatent draws from the artifact's key
    eps = np.array(jax.random.normal(key, (B, jcfg_.hop.z_size), jnp.float32))
    args = [torch.from_numpy(a) for a in (*inputs, eps)]
    args[2], args[4] = args[2].long(), args[4].long()
    loaded = infer.load_exported(infer.export_forward(model, model.cfg, B, device="cpu"))
    got = loaded(*args)
    assert got.shape == (B, d.n_poses, d.pose_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_TOL)
    with torch.inference_mode():
        eager = model(*args[:5], eps=args[5])[0]
    assert torch.equal(got, eager)


def _tiny(gru_kernel="fused", attention="plain"):
    import dataclasses
    cfg = tcfg.tiny_test_config()
    return cfg.replace(hop=dataclasses.replace(cfg.hop, gru_kernel=gru_kernel),
                       llm=dataclasses.replace(cfg.llm, attention=attention))


def _random_inputs(cfg, B, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(t.shape, generator=g) if t.is_floating_point()
            else torch.randint(0, 5, t.shape, generator=g)
            for t in infer.serving_inputs(cfg, B, "cpu")]


@pytest.mark.parametrize("gru_kernel,attention", ROUTES)
def test_graph_calls_the_registered_ops(gru_kernel, attention):
    """The program calls the registered op of every kernel on its route,
    and neither a library's attention nor GRU nor the plain versions'
    recurrences; its forward is the eager one, bitwise, as is
    `compile_forward`'s."""
    cfg = _tiny(gru_kernel, attention)
    model = build_hop_model(cfg, 5, seed=2, device="cpu")
    loaded = infer.load_exported(infer.export_forward(model, cfg, 2, device="cpu"))
    targets = loaded.call_targets()
    want = {"reprogramming_attention_fwd",
            "gru_fused_layer_fwd" if gru_kernel == "fused" else "gru_stack_fwd",
            *{"fused": ["fused_attention_fwd"], "block": ["block_attention_fwd"]}.get(
                attention, [])}
    assert {t.split(".")[1] for t in targets if t.startswith("hop_tpu_torch.")} == want
    assert not any(s in t for t in targets for s in
                   ("scaled_dot_product", "aten.gru", "cudnn_rnn", "aten.rnn"))
    # nor the plain versions' products (K1's scores, the GRUs' per-step
    # recurrent products and input projection, K4's and K5's scores)
    equations = {n.args[0] for n in loaded.program.graph.nodes
                 if n.op == "call_function" and "einsum" in str(n.target)}
    assert not equations & {"blhe,hse->bhls", "bk,gkh->gbh", "tbi,gih->gtbh",
                            "bqhd,bkhd->bhqk", "gmhd,gnhd->ghmn"}
    inputs = _random_inputs(cfg, 2)
    with torch.inference_mode():
        eager = model(*inputs[:5], eps=inputs[5])[0]
    assert torch.equal(loaded(*inputs), eager)
    assert torch.equal(infer.compile_forward(model, cfg, 2, device="cpu")(*inputs), eager)


LOADER = r"""
import json, sys, torch
torch.set_num_threads(1)
from hop_tpu_torch import infer
fwd = infer.load_exported(open(sys.argv[1], "rb").read())
io = torch.load(sys.argv[2])
out = fwd(*io["inputs"])
print(json.dumps({"models": sorted(m for m in sys.modules
                                   if m.startswith("hop_tpu_torch.models")),
                  "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                                ("jax", "flax", "hop_tpu")),
                  "equal": bool(torch.equal(out, io["eager"]))}))
"""


def test_artifact_loads_and_runs_without_model_code(tmp_path):
    """A fresh process (one torch thread, as this module's) imports only
    hop_tpu_torch.infer, loads the artifact and runs it: bitwise the eager
    forward, and no module of hop_tpu_torch.models, jax or hop_tpu loaded."""
    cfg = _tiny("stack", "block")
    model = build_hop_model(cfg, 5, seed=4, device="cpu")
    inputs = _random_inputs(cfg, 1, seed=5)
    with torch.inference_mode():
        eager = model(*inputs[:5], eps=inputs[5])[0]
    (tmp_path / "m.pt2").write_bytes(infer.export_forward(model, cfg, 1, device="cpu"))
    torch.save({"inputs": inputs, "eager": eager}, tmp_path / "io.pt")
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", LOADER, str(tmp_path / "m.pt2"),
                           str(tmp_path / "io.pt")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"models": [], "jax": [], "equal": True}


def test_long_form_through_the_loaded_program_is_the_eager_one():
    """`make_exported_forward` draws eps from the caller's generator as the
    eager SpeakerLatent draws it: the same clip, bit for bit."""
    cfg = _tiny()
    model = build_hop_model(cfg, 5, seed=6, device="cpu")
    loaded = infer.load_exported(infer.export_forward(model, cfg, 1, device="cpu"))
    clip = make_clip(cfg, seconds=5.0, seed=2)
    outs = [infer.generate_long_form(cfg, fwd, clip.audio, clip.words, clip.seed_dir_vec,
                                     WordIndex(clip.words), 3,
                                     generator=torch.Generator().manual_seed(11),
                                     device="cpu")
            for fwd in (infer.make_forward(model), infer.make_exported_forward(loaded))]
    assert outs[0].shape == (94, cfg.data.pose_dim)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_export_refuses_a_model_on_another_device():
    cfg = _tiny()
    model = build_hop_model(cfg, 5, seed=0, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        infer.export_forward(model, cfg, 1, device="cuda")


def test_export_model_cli(tmp_path, monkeypatch, capsys):
    """`cli.export_model --device cpu` on a `run_ted` checkpoint: the
    artifact runs and is the restored model's forward; --params-out holds
    the state_dict under its names; two platforms are refused."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ck = str(tmp_path / "ck")
    run_ted.main(["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
                  "--epochs", "1", "--warmup-epochs", "0", "--checkpoint-dir", ck,
                  "--metrics", str(tmp_path / "m.jsonl")])
    out, params = tmp_path / "m.pt2", tmp_path / "p.npz"
    export_model.main(["--device", "cpu", "--tiny", "--checkpoint-dir", ck, "--out", str(out),
                       "--params-out", str(params)])
    log = capsys.readouterr().out
    assert "restored checkpoint step 0" in log and "device=cpu" in log
    from hop_tpu_torch.cli.common import restore_hop_model
    cfg, model, _ = restore_hop_model(_tiny(), ck, device="cpu")
    inputs = _random_inputs(cfg, 1)
    inputs[4] = torch.zeros_like(inputs[4])
    with torch.inference_mode():
        eager = model(*inputs[:5], eps=inputs[5])[0]
    assert torch.equal(infer.load_exported(out.read_bytes())(*inputs), eager)
    flat = np.load(params)
    sd = model.state_dict()
    assert sorted(flat.files) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    with pytest.raises(SystemExit, match="one device"):
        export_model.main(["--platforms", "cpu,cuda", "--tiny", "--checkpoint-dir", ck,
                           "--out", str(out)])
