"""The baseline zoo on the card at the tiny size: each family's nets against
the same nets on the CPU, the word embedding's gradient repeated bit for
bit without a wait for the card, and each family's `run_ted` under
`--transfer-guard disallow`.

Needs an NVIDIA GPU (the GRUs run the CUDA kernels K2, or K3 on the stack
route); on a machine without a card it skips. On the card run it without the
JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_zoo_cuda.py --noconftest -m cuda -q

Tolerance: f32 on both sides (TF32 off; K2's and K3's products 3xTF32),
sums in another order: 1e-4 on outputs of O(1).
"""

import contextlib
import dataclasses
import io
import tempfile

import numpy as np
import pytest
import torch

from hop_tpu_torch.cli import run_ted
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.common import WordEmbedding
from hop_tpu_torch.models.embedding_net import build_embedding_net
from hop_tpu_torch.models.multimodal_context import build_pose_generator
from hop_tpu_torch.models.seq2seq import build_seq2seq
from hop_tpu_torch.models.speech2gesture import build_s2g
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_stack as K3
from hop_tpu_torch.train.gan import build_pre_seq
from hop_tpu_torch.train.loops import sync_debug

pytestmark = pytest.mark.cuda

TOL = 1e-4
B, N_WORDS = 6, 40


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg):
    r = np.random.default_rng(0)
    d = cfg.data
    target = torch.tensor(r.normal(0, 0.3, (B, d.n_poses, d.pose_dim)).astype(np.float32))
    return {"target": target, "pre_seq": build_pre_seq(target, d.n_pre_poses),
            "audio": torch.tensor(r.normal(0, 0.1, (B, d.expected_audio_length))
                                  .astype(np.float32)),
            "words": torch.tensor(r.integers(0, N_WORDS, (B, d.n_poses))),
            "mask": torch.ones(B, d.n_poses),
            "spec": torch.tensor(r.normal(0, 1, (B, 128, 70)).astype(np.float32)),
            "vids": torch.tensor(r.integers(0, 5, B))}


def _nets(cfg, device):
    gen = build_pose_generator(cfg, N_WORDS, 5, 0, device)
    return {"multimodal_context": (gen, lambda x: gen(
                x["pre_seq"], x["words"], x["audio"], x["vids"],
                eps=torch.zeros(B, 16, device=x["vids"].device))[0]),
            "seq2seq": (s2s := build_seq2seq(cfg, N_WORDS, 0, device), lambda x: s2s(
                x["words"], x["mask"], x["target"])),
            "speech2gesture": (g := build_s2g(cfg, 0, device)[0], lambda x: g(
                x["spec"], x["target"][:, :4])),
            "joint_embedding": (e := build_embedding_net(cfg, N_WORDS, "random", 0, device),
                                lambda x: e(x["words"], x["audio"], x["target"][:, :4],
                                            x["target"],
                                            eps=torch.zeros(B, 32, device=x["vids"].device))
                                [-1])}


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
def test_zoo_nets_on_the_card_match_the_cpu(device, gru_kernel):
    cfg = tiny_test_config("TED")
    cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, gru_kernel=gru_kernel))
    x = _inputs(cfg)
    cpu, card = _nets(cfg, "cpu"), _nets(cfg, device)
    before = (K2.launches, K3.lean_launches)
    for name, (net, run) in cpu.items():
        net.eval()
        card[name][0].eval()
        with torch.no_grad():
            want = run(x)
            got = card[name][1]({k: v.to(device) for k, v in x.items()})
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL, msg=name)
    torch.cuda.synchronize()
    assert (K2.launches, K3.lean_launches) != before


def test_word_embedding_gradient_repeats_on_the_card(device):
    """A batch's words, 8704 lookups of the first 20 of 40 ids: two
    backwards bitwise equal, neither waiting for the card (sync debug mode
    "error"), the unused rows zero, and nn.Embedding's gradient (whose CUDA
    backward does not repeat) to round-off."""
    torch.manual_seed(0)
    emb = WordEmbedding(N_WORDS, 300).to(device)
    ref = torch.nn.Embedding(N_WORDS, 300).to(device)
    ref.load_state_dict(emb.state_dict())
    ids = torch.randint(0, N_WORDS // 2, (256, 34), device=device)
    g = torch.randn(256, 34, 300, device=device)
    grads = []
    for _ in range(2):
        emb.weight.grad = None
        out = emb(ids)
        with sync_debug("error"):
            out.backward(g)
        grads.append(emb.weight.grad.clone())
    ref(ids).backward(g)
    assert torch.equal(grads[0], grads[1])
    assert not grads[0][N_WORDS // 2:].any()
    torch.testing.assert_close(grads[0], ref.weight.grad, rtol=0, atol=TOL)


FAMILIES = ["multimodal_context", "seq2seq", "speech2gesture", "joint_embedding",
            "gesture_autoencoder"]


@pytest.mark.parametrize("model", FAMILIES)
def test_zoo_trains_under_the_transfer_guard(device, monkeypatch, tmp_path, model):
    """`run_ted --model X --transfer-guard disallow`: two tiny epochs on the
    card in which no step makes the host wait for it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cuda", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
            "--warmup-epochs", "0", "--log-every", "1", "--epochs", "2", "--prefetch", "2",
            "--transfer-guard", "disallow", "--model", model,
            "--checkpoint-dir", str(tmp_path / "ck")]
    with contextlib.redirect_stdout(io.StringIO()):
        state, _ = run_ted.main(argv)
    assert state.step >= 2
