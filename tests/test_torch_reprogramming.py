"""Kernel K1's module in the port (hop_tpu_torch.ops.reprogramming_attention)
and the port's ReprogrammingLayer against the JAX package.

The JAX kernel `fused_reprogramming_attention` runs in interpret mode, as
tests/test_pallas_reprogramming.py runs it. On the CPU the port's wrapper
takes its plain version. Both are f32 throughout, so the tolerance is f32
round-off of a 128-long dot and a softmax over S keys: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu.models.reprogramming import ReprogrammingLayer as JaxLayer
from hop_tpu.ops.pallas_reprogramming import fused_reprogramming_attention

from hop_tpu_torch.convert import _lin
from hop_tpu_torch.models.reprogramming import ReprogrammingLayer
from hop_tpu_torch.ops import reprogramming_attention as K1

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")


def _inputs(B, L, H, E, S, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, L, H, E)).astype(np.float32),
            r.standard_normal((H, S, E)).astype(np.float32),
            r.standard_normal((H, S, E)).astype(np.float32))


@pytest.mark.parametrize("B,L,H,E,S,scale", [
    (4, 34, 8, 128, 100, 1.0 / 128 ** 0.5),
    (6, 34, 8, 128, 37, 0.125),      # JAX batch block 2 and an odd S
    (3, 34, 4, 16, 65, 0.25),        # odd batch; S one past a 64-key tile
])
def test_plain_matches_pallas_kernel(B, L, H, E, S, scale):
    q, k, v = _inputs(B, L, H, E, S, seed=B + S)
    want = fused_reprogramming_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([0], jnp.int32), scale, 0.0)
    got = K1.reprogramming_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale)
    assert got.dtype == torch.float32 and got.shape == (B, L, H, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_wrapper_takes_plain_version_only_on_cpu():
    """A tensor on neither the CPU nor CUDA gets no silent fallback."""
    q, k, v = (torch.from_numpy(a).to("meta") for a in _inputs(2, 34, 8, 128, 64, 0))
    before = K1.launches
    with pytest.raises(ValueError, match="no kernel"):
        K1.reprogramming_attention(q, k, v, 0.1)
    assert K1.launches == before


def test_layer_matches_jax():
    B, S, d_model, H, E, d_llm = 3, 70, 128, 8, 128, 96
    r = np.random.default_rng(7)
    x = r.standard_normal((B, 34, d_model)).astype(np.float32)
    src = r.standard_normal((S, d_llm)).astype(np.float32)
    jl = JaxLayer(d_model=d_model, n_heads=H, d_keys=E, d_llm=d_llm)
    params = jl.init(jax.random.PRNGKey(0), x, src, src, True)["params"]
    want = jl.apply({"params": params}, x, src, src, True)

    layer = ReprogrammingLayer(d_model, H, E, d_llm).eval()
    sd = {}
    for name in ("query_projection", "key_projection", "value_projection",
                 "out_projection"):
        _lin(sd, name, jax.tree_util.tree_map(np.asarray, params[name]))
    layer.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = layer(torch.from_numpy(x), torch.from_numpy(src),
                    torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
