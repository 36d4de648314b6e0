"""The port's `device_batch` (hop_tpu_torch.cli.common) against
hop_tpu.cli.common.device_batch on the same numpy host batch, on the CPU:
both audio wires, both token streams, the `keys` subset, the word mask.

Transfers and clamps are exact. The log-mel frontends agree to ~1e-3 dB
(f32 round-off of the matmul DFT shows in dB, as tests/test_torch_hop_model.py
states): 2e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.cli.common import MODEL_BATCH_KEYS as JAX_KEYS
from hop_tpu.cli.common import device_batch as jax_device_batch

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli.common import MODEL_BATCH_KEYS, _put_audio, device_batch
from hop_tpu_torch.data.synthetic import make_host_batch, make_train_batch

MEL_TOL = 2e-3
B = 3


def _cfgs(**data):
    out = []
    for mod in (tcfg, jcfg):
        cfg = mod.tiny_test_config("TED")
        out.append(cfg.replace(data=dataclasses.replace(cfg.data, **data)))
    return out


def _host_batch(cfg):
    r = np.random.default_rng(0)
    batch = make_host_batch(cfg, B, seed=1)
    T = cfg.data.n_poses
    # ids beyond the backbone's vocabulary, as the live path's word ids are
    batch["text_padded"] = r.integers(0, 5 * cfg.llm.vocab_size, size=(B, T))
    batch["text_tokens"] = r.integers(0, 5 * cfg.llm.vocab_size, size=(B, T))
    batch["word_seq"] = r.integers(0, 50, size=(B, 9))
    batch["text_lengths"] = np.array([9, 4, 1])
    batch["spectrogram"] = r.normal(size=(B, 8, 5)).astype(np.float32)
    return batch


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if k == "log_mel":
            np.testing.assert_allclose(g, w, rtol=0, atol=MEL_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert np.issubdtype(g.dtype, np.floating) == \
                np.issubdtype(w.dtype, np.floating), k


@pytest.mark.parametrize("wire", ["f32", "int16"])
@pytest.mark.parametrize("hf_tokens", [False, True])
def test_device_batch_matches_jax(wire, hf_tokens):
    cfg, cfg_j = _cfgs(audio_wire=wire, use_hf_token_stream=hf_tokens)
    batch = _host_batch(cfg)
    got = device_batch(batch, cfg, device="cpu")
    _assert_same(got, jax_device_batch(batch, cfg_j))
    assert got["in_audio"].dtype == torch.float32
    assert int(got["text_padded"].max()) < cfg.llm.vocab_size
    source = batch["text_tokens" if hf_tokens else "text_padded"]
    np.testing.assert_array_equal(got["text_padded"].numpy(),
                                  source % cfg.llm.vocab_size)
    np.testing.assert_array_equal(got["text_mask"].numpy().sum(1), [9, 4, 1])


def test_keys_subset_and_no_mel():
    assert MODEL_BATCH_KEYS["AD_LLM"] == JAX_KEYS["AD_LLM"]
    cfg, cfg_j = _cfgs()
    batch = _host_batch(cfg)
    keys = MODEL_BATCH_KEYS["AD_LLM"]
    got = device_batch(batch, cfg, keys=keys, device="cpu")
    _assert_same(got, jax_device_batch(batch, cfg_j, keys=keys))
    assert set(got) == {"in_audio", "log_mel", "target_vec", "vid_indices",
                        "text_padded"}
    got = device_batch(batch, cfg, with_mel=False, keys=("in_audio",), device="cpu")
    _assert_same(got, jax_device_batch(batch, cfg_j, with_mel=False,
                                       keys=("in_audio",)))
    assert set(got) == {"in_audio"}


def test_int16_wire_quantises_and_saturates():
    audio = np.array([[0.0, 0.25, -0.5, 1.5, -1.5, 1e-5, 3 / 32768]], np.float32)
    got = _put_audio(audio, "int16", "cpu").numpy()
    want = np.array([[0.0, 0.25, -0.5, 32767 / 32768, -1.0, 0.0, 3 / 32768]],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    # exact for audio decoded from 16-bit PCM
    pcm = (np.random.default_rng(2).integers(-32768, 32768, size=(2, 1000))
           / 32768.0).astype(np.float32)
    np.testing.assert_array_equal(_put_audio(pcm, "int16", "cpu").numpy(), pcm)
    np.testing.assert_array_equal(_put_audio(pcm, "f32", "cpu").numpy(), pcm)
    with pytest.raises(ValueError, match="audio_wire"):
        _put_audio(pcm, "int8", "cpu")


def test_device_batch_feeds_the_train_step_like_make_train_batch():
    """The host batch through `device_batch` is the batch `make_train_batch`
    builds on the device."""
    cfg = tcfg.tiny_test_config("TED")
    got = device_batch(make_host_batch(cfg, B, seed=4), cfg, device="cpu")
    want = make_train_batch(cfg, B, seed=4, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
