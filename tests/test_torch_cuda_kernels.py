"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper GPU and nvcc: a CUDA kernel has no CPU
mode, so on a machine without a card they skip. On the card run them
without the JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

Tolerances: K1 reads bf16 operands, and both sides get the same
bf16-rounded values, so what differs is f32 summation order and the online
softmax's rescaling: 1e-4 on outputs of O(1). K2 is f32 throughout; its
sums run in another order than cuBLAS's, carried through T steps: 1e-4.
The backwards sum over many more terms (K1's dk/dv over all B*L query
rows, K2's weight gradients over T*B): their tolerance is 1e-4 relative to
the largest gradient. Backward results must repeat bit for bit.
"""

import pytest
import torch

from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import reprogramming_attention as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,H,S", [
    (3, 34, 2, 65),        # ragged batch block and a one-key last tile
    (5, 17, 1, 200),       # 4 samples per block
    (256, 34, 8, 1500),    # the HOP serving shape
])
def test_reprogramming_attention_kernel(device, B, L, H, S):
    g = torch.Generator(device=device).manual_seed(B + S)
    q = torch.randn(B, L, H, 128, device=device, generator=g)
    k = torch.randn(H, S, 128, device=device, generator=g)
    v = torch.randn(H, S, 128, device=device, generator=g)
    before = K1.launches
    got = K1.reprogramming_attention(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    want = K1.plain_reprogramming_attention(
        *(t.to(torch.bfloat16).float() for t in (q, k, v)), 128 ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", [
    (5, 11, 20, 40),        # ragged batch tile
    (34, 256, 992, 350),    # the HOP head's first layer
])
def test_gru_fused_kernel(device, D, T, B, I, H):
    g = torch.Generator(device=device).manual_seed(D * 100 + I)

    def arr(*shape, scale):
        return torch.randn(*shape, device=device, generator=g) * scale
    s = H ** -0.5
    args = (arr(T, B, I, scale=1.0), arr(D, 3, I, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(D, 3, H, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(B, H, scale=0.5))
    before = K2.launches
    got = K2.gru_fused_layer(*args)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    want = K2.plain_gru_fused_layer(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _rel_close(got, want, rel=1e-4, name=""):
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    assert err <= rel * scale, f"{name}: max abs err {err} > {rel} * {scale}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L,H,S", [
    (3, 34, 2, 65),        # ragged batch block and a one-key last tile
    (256, 34, 8, 1500),    # the HOP training shape
])
def test_reprogramming_attention_bwd_kernel(device, B, L, H, S, rate):
    g = torch.Generator(device=device).manual_seed(B + S)
    q, do = (torch.randn(B, L, H, 128, device=device, generator=g) for _ in range(2))
    k, v = (torch.randn(H, S, 128, device=device, generator=g) for _ in range(2))
    q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    scale, seed = 128 ** -0.5, 77
    out, lse = K1.reprogramming_attention_fwd(q, k, v, scale, rate, seed, True)
    want_out, want_lse = K1.plain_reprogramming_attention(q, k, v, scale, rate,
                                                          seed, True)
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    before = K1.bwd_launches
    got = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, scale, rate, seed)
    again = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, scale, rate, seed)
    torch.cuda.synchronize()
    assert K1.bwd_launches == before + 2
    want = K1.plain_reprogramming_attention_bwd(q, k, v, want_out, want_lse, do,
                                                scale, rate, seed)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        _rel_close(a, c, name=name)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", [
    (5, 11, 20, 40),        # ragged batch tile
    (28, 256, 128, 64),     # the discriminator's upper layers
    (34, 256, 992, 350),    # the HOP head's first layer
])
def test_gru_fused_bwd_kernel(device, D, T, B, I, H):
    gen = torch.Generator(device=device).manual_seed(D * 100 + I)

    def arr(*shape, scale):
        return torch.randn(*shape, device=device, generator=gen) * scale
    s = H ** -0.5
    args = (arr(T, B, I, scale=1.0), arr(D, 3, I, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(D, 3, H, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(B, H, scale=0.5))
    g = arr(D, T, B, H, scale=1.0)
    h_seq, r, z, n, hnb = K2.gru_fused_layer_fwd(*args, with_residuals=True)
    want_res = K2.plain_gru_fused_layer(*args, with_residuals=True)
    for a, b in zip((h_seq, r, z, n, hnb), want_res):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    hprev = K2.hprev_of(h_seq, args[5])
    bwd_args = (g, args[0], r, z, n, hnb, hprev, args[1], args[3])
    before = K2.bwd_launches
    got = K2.gru_fused_layer_bwd(*bwd_args)
    again = K2.gru_fused_layer_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert K2.bwd_launches == before + 2
    want = K2.plain_gru_fused_layer_bwd(*bwd_args)
    for name, a, b, c in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"),
                             got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        _rel_close(a, c, name=name)


def test_wrappers_check_operands(device):
    x = torch.zeros(3, 2, 4, device=device, dtype=torch.float64)
    w = torch.zeros(1, 3, 4, 8, device=device)
    with pytest.raises(ValueError, match="float32"):
        K2.gru_fused_layer(x, w, torch.zeros(1, 3, 1, 8, device=device),
                           torch.zeros(1, 3, 8, 8, device=device),
                           torch.zeros(1, 3, 1, 8, device=device),
                           torch.zeros(2, 8, device=device))
    with pytest.raises(ValueError, match="E == 128"):
        K1.reprogramming_attention(torch.zeros(1, 34, 2, 64, device=device),
                                   torch.zeros(2, 5, 64, device=device),
                                   torch.zeros(2, 5, 64, device=device), 0.1)
