"""The hierarchy on the card at the tiny size: K2 and K3 at the cascade's
new input widths against the CPU, the TED and Expressive warmup and GAN
steps on the card against the same steps on the CPU (both GRU routes), and
`run_ted` / `run_expressive --model hierarchy` under `--transfer-guard
disallow` resumed bit for bit.

Needs an NVIDIA GPU (the GRUs run the CUDA kernels K2, or K3 on the stack
route); on a machine without a card it skips. On the card run it without the
JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_hierarchy_cuda.py --noconftest -m cuda -q

Tolerances: f32 on both sides (TF32 off; K2's and K3's products 3xTF32),
sums in another order: a GRU layer's outputs and input gradients 1e-4 of
their largest; a step's losses 1e-4 relative and each gradient tensor
STEP_GRAD_TOL of its net's largest gradient (the generator side and the
discriminator apart): a tensor's own largest element is no scale where a
BatchNorm after a ReLU normalises a channel of few non-zero values (the
ResNetSE's conv1 -> relu -> bn order), whose gradient then differs between
any two f32 summation orders by up to 1e-1 of itself (readings on an H100:
2.5e-4 of the net's largest on TED, 5.2e-5 on Expressive). Dropout is off
on both sides, since CUDA and CPU generators draw other masks.
"""

import contextlib
import dataclasses
import io
import tempfile

import numpy as np
import pytest
import torch

from hop_tpu_torch.cli import run_expressive, run_ted
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.hierarchy import HierarchicalConvDiscriminator, HierarchyNet
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_stack as K3
from hop_tpu_torch.ops.gru import GRU
from hop_tpu_torch.train.hierarchy import make_hierarchy_train_steps
from hop_tpu_torch.train.llm import StepNoise
from hop_tpu_torch.utils.checkpoint import CheckpointManager, differing_entries

pytestmark = pytest.mark.cuda

B = 6
STEP_GRAD_TOL = 1e-3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["fused", "stack"])
@pytest.mark.parametrize("I,H", [(96, 300), (102, 300), (105, 300), (111, 300), (117, 300),
                                 (147, 300), (177, 300), (1751, 350)])
def test_gru_at_the_new_widths_matches_the_cpu(device, kernel, I, H):
    torch.manual_seed(I)
    cpu = GRU(I, H, num_layers=2, bidirectional=True, kernel=kernel)
    card = GRU(I, H, num_layers=2, bidirectional=True, kernel=kernel).to(device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(B, 34, I)
    outs = []
    for net, xs in ((cpu, x.clone().requires_grad_()),
                    (card, x.to(device).requires_grad_())):
        y, _ = net(xs)
        y.square().sum().backward()
        outs.append((y.detach().cpu(), xs.grad.cpu()))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


def _step_nets(cfg, device):
    torch.manual_seed(0)
    net = HierarchyNet(cfg, 40, 5, resnet_layers=(1, 1, 1, 1))
    disc = HierarchicalConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    for m in (*net.modules(), *disc.modules()):
        for attr in ("dropout", "emb_dropout"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    return net.to(device), disc.to(device)


@pytest.mark.parametrize("kernel", ["fused", "stack"])
@pytest.mark.parametrize("kind", ["warmup", "gan"])
@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_hierarchy_step_on_the_card_matches_the_cpu(device, dataset, kind, kernel):
    cfg = tiny_test_config(dataset)
    cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, gru_kernel=kernel))
    r = np.random.default_rng(0)
    batch = {"spectrogram": torch.tensor(r.normal(-45, 5, (B, 128, 70)).astype(np.float32)),
             "text_padded": torch.tensor(r.integers(0, 40, (B, 34))),
             "target_vec": torch.tensor(r.normal(0, 0.2, (B, 34, cfg.data.pose_dim))
                                        .astype(np.float32)),
             "vid_indices": torch.tensor(r.integers(0, 5, B))}
    n_stages = 3 if dataset == "TED" else 6
    noise = StepNoise.draw_stages(torch.Generator().manual_seed(1), n_stages, B, 16)
    results = []
    before = (K2.launches, K3.launches)
    for dev in ("cpu", device):
        net, disc = _step_nets(cfg, dev)
        warmup, gan, init_state = make_hierarchy_train_steps(cfg, net, disc)
        _, metrics = (warmup if kind == "warmup" else gan)(
            init_state(), {k: v.to(dev) for k, v in batch.items()}, noise)
        grads = {f"{n}{k}": p.grad.cpu() for n, m in (("G.", net), ("D.", disc))
                 for k, p in m.named_parameters() if p.grad is not None}
        results.append(({k: v.item() for k, v in metrics.items()}, grads))
    torch.cuda.synchronize()
    assert (K2.launches, K3.launches) != before
    (want_m, want_g), (got_m, got_g) = results
    assert got_m.keys() == want_m.keys()
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got_g.keys() == want_g.keys()
    # the warmup step leaves the discriminator without gradients
    assert any(k.startswith("D.") for k in want_g) == (kind == "gan")
    for net in ("G.", "D.")[:2 if kind == "gan" else 1]:
        top = max(g.abs().max().item() for k, g in want_g.items() if k.startswith(net))
        errs = {k: (got_g[k] - g).abs().max().item() / top for k, g in want_g.items()
                if k.startswith(net)}
        worst = max(errs, key=errs.get)
        print(f"{dataset} {kind} {kernel}: {net} worst {worst} {errs[worst]:.2e} of the "
              f"net's largest gradient")
        assert errs[worst] <= STEP_GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("entry", [run_ted, run_expressive], ids=["ted", "expressive"])
def test_hierarchy_resumes_bitwise_under_the_transfer_guard(device, monkeypatch, tmp_path,
                                                            entry):
    """Two tiny epochs straight, and one resumed to two, under
    `--transfer-guard disallow` (no step makes the host wait for the card):
    the same checkpoint, bit for bit."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def run(name, epochs, *extra):
        argv = ["--device", "cuda", "--tiny", "--synthetic-videos", "1", "--batch-size", "8",
                "--warmup-epochs", "0", "--epochs", str(epochs), "--prefetch", "2",
                "--transfer-guard", "disallow", "--model", "hierarchy",
                "--checkpoint-dir", str(tmp_path / name), *extra]
        with contextlib.redirect_stdout(io.StringIO()):
            return entry.main(argv)[0]
    assert run("whole", 2).step >= 2
    run("split", 1)
    run("split", 2, "--resume")
    assert differing_entries(CheckpointManager(str(tmp_path / "whole")).restore(1),
                             CheckpointManager(str(tmp_path / "split")).restore(1)) == []
