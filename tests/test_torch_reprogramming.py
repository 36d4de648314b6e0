"""Kernel K1's module in the port (hop_tpu_torch.ops.reprogramming_attention)
and the port's ReprogrammingLayer against the JAX package.

The JAX kernel `fused_reprogramming_attention` runs in interpret mode, as
tests/test_pallas_reprogramming.py runs it. On the CPU the port's wrapper
takes its plain version. Both are f32 throughout, so the tolerance is f32
round-off of a 128-long dot and a softmax over S keys: 1e-5.

The forward kernel's own arithmetic (bf16 operands, 64-key tiles with a
ragged last one, the online max and sum in the exp2 domain, the dropped
probabilities fed to the second product as hi + lo bf16, key splits combined
in order) cannot run without a card; `tiled_reprogramming_attention` repeats
it in torch. Against the plain version and the JAX kernel on the same
bf16-rounded operands what differs is f32 summation order, the rescaling by
exp2(m_old - m_new) and the 2^-17 relative error of a hi + lo pair, on
outputs of O(1): 1e-4, the tolerance the kernel is held to on the card.
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
TILED_TOL = 1e-4


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


def _bf16_exact(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrays]


# B = 1 and 3; L = 34 and 50 divide no 64-row tile; S = 150 is two key tiles
# and 22 keys, S = 40 less than one; n_split None is the wrapper's choice
TILED_CASES = [(1, 34, 2, 150, None), (3, 34, 2, 150, 1), (3, 50, 1, 150, 2),
               (3, 34, 2, 150, 3), (1, 34, 8, 40, None)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L,H,S,n_split", TILED_CASES)
def test_tiled_walk_matches_plain_version(B, L, H, S, n_split, rate):
    q, k, v = _bf16_exact(*_inputs(B, L, H, 128, S, seed=B + S))
    scale = 128 ** -0.5
    got, lse = K1.tiled_reprogramming_attention(q, k, v, scale, rate, 11,
                                                with_lse=True, n_split=n_split)
    want, want_lse = K1.plain_reprogramming_attention(q, k, v, scale, rate, 11,
                                                      with_lse=True)
    assert got.shape == want.shape and lse.shape == want_lse.shape == (B, L, H)
    torch.testing.assert_close(got, want, rtol=0, atol=TILED_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=TILED_TOL)
    if rate > 0.0:      # the mask took effect, and the LSE is of undropped scores
        undropped = K1.plain_reprogramming_attention(q, k, v, scale)
        assert (got - undropped).abs().max().item() > 1e-2
        torch.testing.assert_close(
            lse, K1.tiled_reprogramming_attention(q, k, v, scale, with_lse=True,
                                                  n_split=n_split)[1])


@pytest.mark.parametrize("B,L,H,S,n_split", TILED_CASES)
def test_tiled_walk_matches_pallas_kernel(B, L, H, S, n_split):
    q, k, v = _bf16_exact(*_inputs(B, L, H, 128, S, seed=B + S))
    scale = 128 ** -0.5
    want = fused_reprogramming_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray([0], jnp.int32), scale, 0.0)
    got = K1.tiled_reprogramming_attention(q, k, v, scale, n_split=n_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TILED_TOL)


def test_split_runs_agree_with_one_run():
    """However S is cut into runs, the combined result is the one run's to
    f32 round-off."""
    q, k, v = _bf16_exact(*_inputs(2, 34, 2, 128, 300, seed=5))
    one = K1.tiled_reprogramming_attention(q, k, v, 0.1, 0.1, 3, n_split=1)
    for n_split in (2, 3, 5):
        got = K1.tiled_reprogramming_attention(q, k, v, 0.1, 0.1, 3, n_split=n_split)
        torch.testing.assert_close(got, one, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,L,H,S,want", [
    (256, 34, 8, 1500, 1),     # the HOP batch: 136 row tiles x 8 heads
    (250, 34, 8, 1500, 1),
    (32, 34, 8, 1500, 1),      # 17 row tiles x 8 heads = 136 blocks
    (16, 34, 8, 1500, 2),      # 72 blocks: two runs of 12 tiles
    (8, 34, 8, 1500, 4),       # 40 blocks: four runs of 6 tiles
    (1, 34, 8, 1500, 12),      # one window of a clip: 8 blocks, runs of 2 tiles
    (1, 34, 8, 40, 1),         # one key tile cannot be split
    (1, 34, 2, 150, 3),        # three tiles, one a run
])
def test_split_count_is_pinned(B, L, H, S, want):
    assert K1.split_count(B, L, H, S) == want


def test_split_count_gives_every_run_a_tile():
    """What the C entry demands of the count it is handed."""
    for B in (1, 2, 3, 5, 9, 17, 40):
        for H in (1, 2, 8):
            for S in (1, 63, 64, 65, 150, 700, 1500, 5000):
                n = K1.split_count(B, 34, H, S)
                tiles = -(-S // K1.KEY_TILE)
                per_run = -(-tiles // n)
                assert 1 <= n <= tiles and (n - 1) * per_run < tiles, (B, H, S, n)
