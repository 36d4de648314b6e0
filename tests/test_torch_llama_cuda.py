"""The LLaMA path's kernels on the card: K2 at the head's first layer on the
LLaMA backbone (I = 28 + 180 + 4096 + 16 = 4320) against its plain version,
and HOP on a tiny-width LLaMA backbone, card against CPU.

Needs an NVIDIA GPU and nvcc; on a machine without a card it skips. On the
card run it without the JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_llama_cuda.py --noconftest -m cuda -q

Tolerances: K2's forward 1e-4 on outputs of O(1), as
tests/test_torch_cuda_kernels.py holds it (f32 throughout; above K = 1024
its projection sums each 8-deep step of K in a tensor-core chain of its own
and adds the steps in f32, since one chain over 4320 truncated to 2.7e-4);
its backward 1e-4 relative to each gradient's largest element; both repeat
bit for bit. The HOP forward in f32 (compute_bf16=False) on the card
against the CPU's plain versions: K1 reads bf16-rounded operands on the
card (2^-8 relative on the queries, keys and values of the reprogramming
attention) where the CPU reads f32, and that rounding is carried through
align_layer, the backbone and the head: 1e-2 on outputs of O(0.1-1), where
a wrong layer or route differs by O(0.1).
"""

import dataclasses

import pytest
import torch

from hop_tpu_torch.config import tiny_llama_llm_config, tiny_test_config
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import reprogramming_attention as K1

pytestmark = pytest.mark.cuda

K2_TOL = 1e-4
BWD_REL_TOL = 1e-4
HOP_TOL = 1e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(device, T, B, I, H, D=2, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    s = H ** -0.5

    def arr(*shape, scale=s):
        return torch.randn(*shape, device=device, generator=g) * scale
    return (arr(T, B, I, scale=1.0), arr(D, 3, I, H), arr(D, 3, 1, H),
            arr(D, 3, H, H), arr(D, 3, 1, H), arr(B, H, scale=0.5))


@pytest.mark.parametrize("B", [256, 13])
def test_k2_at_the_llama_heads_width(device, B):
    T, I, H = 34, 4320, 350
    args = _layer(device, T, B, I, H)
    got = K2.gru_fused_layer_fwd(*args, with_residuals=True)
    again = K2.gru_fused_layer_fwd(*args, with_residuals=True)
    lean = K2.gru_fused_layer(*args)
    want = K2.plain_gru_fused_layer(*args, with_residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(lean, got[0])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=K2_TOL)

    h_seq, r, z, n, hnb = got
    dout = torch.randn(2, T, B, H, device=device,
                       generator=torch.Generator(device=device).manual_seed(1))
    bwd = (dout, args[0], r, z, n, hnb, K2.hprev_of(h_seq, args[5]), args[1], args[3])
    grads = K2.gru_fused_layer_bwd(*bwd)
    assert all(torch.equal(a, b) for a, b in zip(grads, K2.gru_fused_layer_bwd(*bwd)))
    for name, a, b in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"), grads,
                          K2.plain_gru_fused_layer_bwd(*bwd)):
        top = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=BWD_REL_TOL * top, msg=name)


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
def test_tiny_llama_hop_forward_card_vs_cpu(device, gru_kernel):
    cfg = tiny_test_config()
    cfg = cfg.replace(
        llm=dataclasses.replace(tiny_llama_llm_config(), compute_bf16=False),
        hop=dataclasses.replace(cfg.hop, d_ff=K1.HEAD_DIM, gru_kernel=gru_kernel))
    model_cpu = build_hop_model(cfg, 10, seed=3, device="cpu")
    model = build_hop_model(cfg, 10, seed=3, device=device)
    d = cfg.data
    g = torch.Generator().manual_seed(4)
    B = 5
    inputs = (torch.randn(B, d.expected_audio_length, generator=g),
              torch.randn(B, d.n_poses, d.mel_bins, generator=g),
              torch.randint(0, cfg.llm.vocab_size, (B, d.n_poses), generator=g),
              torch.randn(B, d.n_seed_frames, d.pose_dim, generator=g),
              torch.randint(0, 10, (B,), generator=g))
    eps = torch.randn(B, cfg.hop.z_size, generator=g)
    K1.launches = 0
    with torch.inference_mode():
        want = model_cpu(*inputs, eps=eps)[0]
        got = model(*(t.to(device) for t in inputs), eps=eps.to(device))[0]
    assert K1.launches == 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=HOP_TOL)
