"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper GPU and nvcc: a CUDA kernel has no CPU
mode, so on a machine without a card they skip. On the card run them
without the JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

Tolerances: K1 reads bf16 operands, and both sides get the same
bf16-rounded values, so what differs is f32 summation order and the online
softmax's rescaling: 1e-4 on outputs of O(1). K2 is f32 throughout; its
sums run in another order than cuBLAS's, carried through T steps: 1e-4.
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
