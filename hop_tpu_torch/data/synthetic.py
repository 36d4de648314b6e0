"""Seeded synthetic data: a training batch for the train step, a speech
clip for the long-form path, and the word helpers it needs (jax-free
counterparts of hop_tpu.data.synthetic's batches and source clips,
hop_tpu.data.preprocessor.get_words_in_time_range and the index order of
hop_tpu.data.vocab.Vocab).

The clip is numpy: tones over noise for the audio, timed words, and seed
dir-vecs (unit bone directions from a smooth random walk, as the
preprocessed dataset holds them). No real data ships with the repo.

`make_train_batch` has the fields of hop_tpu.data.synthetic.make_batch
(:32-90) that the HOP train step reads, with log-mel computed on the
device; its ids stay below the backbone's vocabulary, and its dir-vecs are
unit bone directions, not centred on the dataset's mean pose.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.ops import mel as mel_ops

_WORDS = ("the quick brown fox jumps over a lazy dog while people "
          "talk about ideas and wave their hands in the air").split()


@dataclass
class SyntheticClip:
    audio: np.ndarray           # (n_samples,) f32 at cfg.data.sample_rate
    words: list                 # [(word, start_s, end_s), ...] in time order
    seed_dir_vec: np.ndarray    # (n_seed_frames, pose_dim) f32


def make_clip(cfg: Config, seconds: float = 20.0, seed: int = 0) -> SyntheticClip:
    rng = np.random.default_rng(seed)
    d = cfg.data
    n = int(seconds * d.sample_rate)
    t = np.arange(n) / d.sample_rate
    audio = 0.01 * rng.standard_normal(n)
    audio += 0.2 * np.sin(2 * np.pi * rng.uniform(100, 500) * t)
    decay = np.exp(-np.arange(4000) / 1500)
    for _ in range(int(seconds * 2)):          # decaying tone bursts
        start = int(rng.integers(0, n - 4000))
        seg = np.sin(2 * np.pi * rng.uniform(80, 1000) * t[:4000])
        audio[start:start + 4000] += 0.2 * seg * decay
    words = []
    wt = 0.2
    while wt < seconds - 0.4:
        dur = rng.uniform(0.15, 0.5)
        words.append((_WORDS[rng.integers(len(_WORDS))], wt, wt + dur))
        wt += dur + rng.uniform(0.02, 0.2)
    n_bones = d.pose_dim // 3
    walk = np.cumsum(rng.standard_normal((d.n_seed_frames, n_bones, 3)) * 0.1,
                     axis=0) + rng.standard_normal((1, n_bones, 3))
    walk /= np.linalg.norm(walk, axis=-1, keepdims=True) + 1e-8
    return SyntheticClip(audio.astype(np.float32), words,
                         walk.reshape(d.n_seed_frames, -1).astype(np.float32))


def make_train_batch(cfg: Config, batch_size: int, seed: int = 0,
                     n_speakers: int = 10,
                     device: torch.device | str = "cpu") -> dict:
    """One training batch on `device`: in_audio (B, samples) tones and
    clicks over noise, log_mel (B, 34, 128) computed there, text_padded
    (B, 34) sparse frame-aligned word ids, target_vec (B, 34, pose_dim)
    smooth unit dir-vec walks, vid_indices (B,) speakers."""
    rng = np.random.default_rng(seed)
    d = cfg.data
    T, n_bones = d.n_poses, d.pose_dim // 3
    t = np.arange(d.expected_audio_length) / d.sample_rate
    audio = 0.01 * rng.standard_normal((batch_size, t.size))
    decay = np.exp(-np.arange(4000) / 1500)
    for b in range(batch_size):
        for _ in range(3):
            start = int(rng.integers(0, t.size - 4000))
            seg = np.sin(2 * np.pi * rng.uniform(80, 1000) * t[:4000])
            audio[b, start:start + 4000] += 0.2 * seg * decay
    steps = rng.standard_normal((batch_size, T, n_bones, 3)) * 0.15
    walk = np.cumsum(steps, axis=1) + rng.standard_normal((batch_size, 1, n_bones, 3))
    walk /= np.linalg.norm(walk, axis=-1, keepdims=True) + 1e-8
    text = np.zeros((batch_size, T), np.int64)
    vocab = min(1000, cfg.llm.vocab_size)
    for b in range(batch_size):
        n_words = int(rng.integers(3, 9))
        space = T // (n_words + 1)
        text[b, (np.arange(n_words) + 1) * space] = rng.integers(4, vocab, size=n_words)
    in_audio = torch.tensor(audio, dtype=torch.float32, device=device)
    return {
        "in_audio": in_audio,
        "log_mel": mel_ops.log_mel_spectrogram(
            in_audio, sr=d.sample_rate, n_fft=d.mel_n_fft, hop=d.mel_hop,
            n_mels=d.mel_bins),
        "text_padded": torch.tensor(text, device=device),
        "target_vec": torch.tensor(walk.reshape(batch_size, T, -1),
                                   dtype=torch.float32, device=device),
        "vid_indices": torch.tensor(rng.integers(0, n_speakers, size=batch_size),
                                    device=device),
    }


class WordIndex:
    """Word -> id with the reference vocabulary's order: <PAD> 0, <SOS> 1,
    <EOS> 2, <UNK> 3, then words in order of first appearance."""

    UNK_token = 3

    def __init__(self, words):
        self.word2index = {}
        for w in words:
            token = w[0] if isinstance(w, (tuple, list)) else w
            self.word2index.setdefault(token, 4 + len(self.word2index))
        self.n_words = 4 + len(self.word2index)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, self.UNK_token)


def get_words_in_time_range(word_list, start_time, end_time):
    """(word, start, end) entries overlapping [start, end), as lists."""
    out = []
    for word in word_list:
        ws, we = word[1], word[2]
        if ws >= end_time:
            break
        if we <= start_time:
            continue
        out.append(list(word))
    return out
