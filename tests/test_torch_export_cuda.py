"""The registered operators and the serving export on the card.

Needs an NVIDIA GPU (the operators' CUDA implementations launch the CUDA
kernels K1-K5); on a machine without a card it skips. On the card run it
without the JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_export_cuda.py --noconftest -m cuda -q

Each operator on CUDA tensors is its kernel's wrapper behind the
dispatcher: the result is bitwise the direct wrapper call's, and the call
counts one launch. `torch.library.opcheck` holds each operator's schema,
fake implementation and dispatch on the card. A program exported and
loaded on the card at a small config runs the same kernels as the eager
forward: bitwise, with the same launches.
"""

import dataclasses

import pytest
import torch

from hop_tpu_torch import infer
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.ops import attention as K4
from hop_tpu_torch.ops import block_attention as K5
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_stack as K3
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


def _cases(dev):
    """(op, wrapper, args, (module, counter)) at small shapes of each kernel."""
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=g)
    T, B, I, H, D = 9, 5, 24, 40, 2
    gru = (r(T, B, I), r(D, 3, I, H) * 0.2, r(D, 3, 1, H), r(D, 3, H, H) * 0.2,
           r(D, 3, 1, H), r(B, H))
    proj = r(T, B, D, 3, H)
    xr, xz, xn = (s.permute(2, 0, 1, 3) for s in proj.unbind(dim=3))
    stack = (xr, xz, xn, gru[3], gru[4], gru[5])
    attn = (r(3, 34, 2, 64), r(3, 34, 2, 64), r(3, 34, 2, 64), 0.125, 0.1, 7)
    return [
        ("reprogramming_attention_fwd", K1.reprogramming_attention_fwd,
         (r(2, 34, 2, 128), r(2, 70, 128), r(2, 70, 128), 0.08, 0.1, 5), (K1, "launches")),
        ("gru_fused_layer_fwd", K2.gru_fused_layer_fwd, gru, (K2, "launches")),
        ("gru_stack_fwd", K3.gru_stack_fwd, stack, (K3, "lean_launches")),
        ("fused_attention_fwd", K4.fused_attention_fwd, attn, (K4, "launches")),
        ("block_attention_fwd", K5.block_attention_fwd, attn, (K5, "launches")),
    ]


@pytest.mark.parametrize("index", range(5))
def test_op_is_the_wrapper_on_the_card(device, index):
    name, wrapper, args, (module, counter) = _cases(device)[index]
    op = getattr(torch.ops.hop_tpu_torch, name)
    want = wrapper(*args)
    setattr(module, counter, 0)
    got = op(*args)
    torch.cuda.synchronize()
    assert getattr(module, counter) == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    with torch._subclasses.fake_tensor.FakeTensorMode():
        fake_args = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device)
                     if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    assert fake.shape == want.shape and fake.dtype == want.dtype
    assert fake.device == want.device


@pytest.mark.parametrize("index", range(5))
def test_opcheck_on_the_card(device, index):
    name, _, args, _ = _cases(device)[index]
    torch.library.opcheck(getattr(torch.ops.hop_tpu_torch, name).default, args)


def _card_config(gru_kernel, attention):
    """The tiny config with K1's head width (d_ff 128) and, for the kernel
    attention routes, K4's and K5's head width (one 64-wide head)."""
    cfg = tiny_test_config()
    return cfg.replace(
        hop=dataclasses.replace(cfg.hop, d_ff=K1.HEAD_DIM, gru_kernel=gru_kernel),
        llm=dataclasses.replace(cfg.llm, n_heads=1, attention=attention))


@pytest.mark.parametrize("gru_kernel,attention,B", [
    ("fused", "plain", 1), ("fused", "plain", 6), ("stack", "fused", 2),
    ("stack", "block", 3)])
def test_export_and_load_on_the_card(device, gru_kernel, attention, B):
    cfg = _card_config(gru_kernel, attention)
    model = build_hop_model(cfg, 5, seed=3, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    inputs = [torch.randn(t.shape, device=device, generator=g) if t.is_floating_point()
              else torch.randint(0, 5, t.shape, device=device, generator=g)
              for t in infer.serving_inputs(cfg, B, device)]
    with torch.inference_mode():
        want = model(*inputs[:5], eps=inputs[5])[0]
    loaded = infer.load_exported(infer.export_forward(model, cfg, B, device=device))
    for m, c in ((K1, "launches"), (K2, "launches"), (K3, "lean_launches"),
                 (K4, "launches"), (K5, "launches")):
        setattr(m, c, 0)
    got = loaded(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    layers = cfg.hop.gru_layers
    assert (K1.launches, K2.launches, K3.lean_launches) == (
        1, layers * (gru_kernel == "fused"), layers * (gru_kernel == "stack"))
    assert (K4.launches, K5.launches) == (cfg.llm.n_layers * (attention == "fused"),
                                          cfg.llm.n_layers * (attention == "block"))
    assert loaded.device.type == "cuda"
