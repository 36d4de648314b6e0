"""Seeded synthetic data: a training batch for the train step, a speech
clip for the long-form path, and source clips for the offline
preprocessor (jax-free counterparts of hop_tpu.data.synthetic's batches
and source clips).

The clip is numpy: tones over noise for the audio, timed words, and seed
dir-vecs (unit bone directions from a smooth random walk, as the
preprocessed dataset holds them). No real data ships with the repo.

`make_host_batch` has the fields of hop_tpu.data.synthetic.make_batch
(:32-90) that the HOP train step reads; `make_train_batch` is the same
batch on the device with log-mel computed there; its ids stay below the backbone's vocabulary, and its dir-vecs are
unit bone directions, not centred on the dataset's mean pose.

`make_source_clips` draws from one `np.random.default_rng(seed)` in
hop_tpu's order, so every field of its clips but the spectrogram (the
port's log-mel frontend, ~1e-3 dB from hop_tpu's) is bitwise hop_tpu's.
`WordIndex` and `get_words_in_time_range` keep their import path here for
the long-form callers; they live in `data.vocab` and `data.preprocessor`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.data.preprocessor import SourceClip, get_words_in_time_range  # noqa: F401
from hop_tpu_torch.data.vocab import Vocab
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


def make_host_batch(cfg: Config, batch_size: int, seed: int = 0,
                    n_speakers: int = 10) -> dict:
    """One training batch as the data loader would hand it over, numpy
    arrays on the host: in_audio (B, samples) f32 tones and clicks over
    noise, text_padded (B, 34) int64 sparse frame-aligned word ids,
    target_vec (B, 34, pose_dim) f32 smooth unit dir-vec walks, vid_indices
    (B,) int64 speakers. `cli.common.device_batch` brings it to the device."""
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
    return {
        "in_audio": audio.astype(np.float32),
        "text_padded": text,
        "target_vec": walk.reshape(batch_size, T, -1).astype(np.float32),
        "vid_indices": rng.integers(0, n_speakers, size=batch_size),
    }


def make_train_batch(cfg: Config, batch_size: int, seed: int = 0,
                     n_speakers: int = 10,
                     device: torch.device | str = "cuda") -> dict:
    """`make_host_batch` as tensors on `device`, with log_mel (B, 34, 128)
    computed there."""
    d = cfg.data
    batch = {k: torch.tensor(v, device=device)
             for k, v in make_host_batch(cfg, batch_size, seed, n_speakers).items()}
    batch["log_mel"] = mel_ops.log_mel_spectrogram(
        batch["in_audio"], sr=d.sample_rate, n_fft=d.mel_n_fft, hop=d.mel_hop,
        n_mels=d.mel_bins)
    return batch


def make_source_clips(cfg: Config, n_videos: int = 2, clips_per_video: int = 1,
                      clip_seconds: float = 12.0, seed: int = 0):
    """[(vid, [SourceClip, ...]), ...] for the offline preprocessor:
    skeleton walks anchored near the dataset's mean pose (so the motion
    filters pass), a tone over noise for the audio, its cached spectrogram,
    and timed words (hop_tpu/data/synthetic.py:93)."""
    rng = np.random.default_rng(seed)
    skel = cfg.data.skeleton
    sr = cfg.data.sample_rate
    native_fps = 25
    videos = []
    mean_pose = (skel.mean_pose.reshape(-1, 3)
                 if skel.mean_pose is not None
                 else np.zeros((skel.n_joints, 3), np.float32))
    for v in range(n_videos):
        clips = []
        for _ in range(clips_per_video):
            n_frames = int(clip_seconds * native_fps)
            # mean-reverting wander so the spine stays upright (the motion
            # filters must pass): x_{t+1} = 0.95 x_t + noise
            walk = np.zeros((n_frames, skel.n_joints, 3))
            x = np.zeros((skel.n_joints, 3))
            for tt in range(n_frames):
                x = 0.95 * x + rng.standard_normal((skel.n_joints, 3)) * 0.02
                walk[tt] = x
            walk[:, :2] *= 0.05  # keep root + neck nearly still
            skeletons = mean_pose[None] + walk
            audio = 0.01 * rng.standard_normal(int(clip_seconds * sr))
            t = np.arange(audio.size) / sr
            audio += 0.2 * np.sin(2 * np.pi * rng.uniform(100, 500) * t)
            spec = mel_ops.extract_melspectrogram(
                torch.from_numpy(audio.astype(np.float32)), sr=sr).numpy()
            words = []
            wt = 0.2
            while wt < clip_seconds - 0.4:
                dur = rng.uniform(0.15, 0.5)
                words.append((_WORDS[rng.integers(len(_WORDS))], wt, wt + dur))
                wt += dur + rng.uniform(0.02, 0.2)
            clips.append(SourceClip(
                vid=f"vid{v}",
                skeletons_3d=skeletons.astype(np.float32),
                audio_raw=audio.astype(np.float32),
                audio_spectrogram=spec.astype(np.float32),
                words=words,
                start_frame_no=0,
                end_frame_no=n_frames,
                start_time=0.0,
                end_time=clip_seconds))
        videos.append((f"vid{v}", clips))
    return videos


class WordIndex(Vocab):
    """A `Vocab` over one clip's words: <PAD> 0, <SOS> 1, <EOS> 2, <UNK> 3,
    then words in order of first appearance."""

    def __init__(self, words):
        super().__init__("words")
        self.add_vocab(w[0] if isinstance(w, (tuple, list)) else w for w in words)
