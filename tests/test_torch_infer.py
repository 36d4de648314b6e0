"""The port's long-form generation (hop_tpu_torch.infer) against
hop_tpu.infer.generate_long_form over a 3-window clip.

Both get the same deterministic stand-in forward, a numpy function of its
inputs, so the comparison pins the windowing, the per-window log-mel, the
word placement, the 16-frame feedback and the 4-frame cross-fade; the
model's own parity is tests/test_torch_hop_model.py. The log-mel enters
the stand-in scaled by 1e-2 (the two frontends agree to ~1e-3 dB), so the
tolerance is 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hop_tpu import config as jcfg
from hop_tpu.data.vocab import build_vocab
from hop_tpu.infer import generate_long_form as jax_generate_long_form

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.data.synthetic import WordIndex, make_clip
from hop_tpu_torch.infer import generate_long_form


def _standin(in_audio, log_mel, text, pre_seq, vid):
    """(1, 34, pose_dim) from every input, numpy in and out."""
    t = np.arange(log_mel.shape[1])
    out = np.tanh(0.01 * log_mel[0].mean(-1)[:, None]
                  + 0.5 * pre_seq[0, t % pre_seq.shape[1]]
                  + 0.01 * text[0][:, None]
                  + 0.5 * in_audio[0, t * 1000][:, None]
                  + 0.1 * vid[0])
    return out[None].astype(np.float32)


def _fake_tokenizer(text):
    return [100 + len(w) for w in text.split()]


@pytest.mark.parametrize("hf_tokens", [False, True])
def test_long_form_matches_jax(hf_tokens):
    cfg = tcfg.ted_config()
    jax_cfg = jcfg.ted_config()
    if hf_tokens:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, use_hf_token_stream=True))
        jax_cfg = jax_cfg.replace(data=dataclasses.replace(
            jax_cfg.data, use_hf_token_stream=True))
    clip = make_clip(cfg, seconds=6.0, seed=3)     # 3 windows of 34 frames
    tokenizer = _fake_tokenizer if hf_tokens else None

    def jax_forward(in_audio, log_mel, text, pre_seq, vid, rng):
        return jnp.asarray(_standin(*(np.asarray(a) for a in
                                      (in_audio, log_mel, text, pre_seq, vid))))

    def port_forward(in_audio, log_mel, text, pre_seq, vid, generator):
        return torch.from_numpy(_standin(*(a.numpy() for a in
                                           (in_audio, log_mel, text, pre_seq, vid))))

    want = jax_generate_long_form(
        jax_cfg, jax_forward, clip.audio, clip.words, clip.seed_dir_vec,
        build_vocab("words", [clip.words]), vid_index=2, tokenizer=tokenizer)
    got = generate_long_form(
        cfg, port_forward, clip.audio, clip.words, clip.seed_dir_vec,
        WordIndex(clip.words), vid_index=2, tokenizer=tokenizer, device="cpu")
    assert got.shape == want.shape == (3 * 34 - 2 * 4, cfg.data.pose_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_word_index_follows_vocab_order():
    clip = make_clip(tcfg.ted_config(), seconds=6.0, seed=4)
    vocab = build_vocab("words", [clip.words])
    index = WordIndex(clip.words)
    assert index.n_words == vocab.n_words
    for w in {w[0] for w in clip.words} | {"<never-seen>"}:
        assert index.get_word_index(w) == vocab.get_word_index(w)
