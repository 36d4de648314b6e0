"""Long-form inference: sliding-window synthesis with cross-fade (port of
hop_tpu/infer.py `generate_long_form`; reference test_checkpoint.py:370-480).

34-frame windows at a 30-frame stride; each window is seeded with the
previous window's last 16 output frames; a 4-frame linear cross-fade joins
consecutive windows. The per-window log-mel is computed on the device.
The forward is any callable; `make_forward` wraps a HOPModel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.data.preprocessor import get_words_in_time_range
from hop_tpu_torch.ops import mel as mel_ops


def make_forward(model) -> Callable:
    """forward_fn for `generate_long_form` from a HOPModel."""
    def forward(in_audio, log_mel, text, pre_seq, vid, generator):
        with torch.inference_mode():
            out, *_ = model(in_audio, log_mel, text, pre_seq, vid,
                            generator=generator)
        return out
    return forward


def generate_long_form(cfg: Config,
                       forward_fn: Callable,
                       clip_audio: np.ndarray,
                       clip_words: list,
                       seed_dir_vec: np.ndarray,
                       lang_model,
                       vid_index: int,
                       tokenizer=None,
                       generator: Optional[torch.Generator] = None,
                       device: torch.device | str = "cuda") -> np.ndarray:
    """forward_fn(in_audio, log_mel, text_ids, pre_seq, vid, generator) ->
    (1, 34, pose_dim), called with tensors on `device`. Returns the stitched
    (total_frames, pose_dim)."""
    d = cfg.data
    sr = d.sample_rate
    n_frames = d.n_poses
    fps = d.pose_resampling_fps
    unit_time = n_frames / fps
    stride_time = (n_frames - d.n_pre_poses) / fps
    clip_length = len(clip_audio) / sr
    if clip_length < unit_time:
        num_subdivision = 1
    else:
        num_subdivision = math.ceil((clip_length - unit_time)
                                    / stride_time) + 1
    audio_sample_length = int(unit_time * sr)

    pre_seq = torch.as_tensor(seed_dir_vec[: d.n_seed_frames],
                              dtype=torch.float32, device=device)[None]
    vid = torch.tensor([vid_index], device=device)

    out_list = []
    outputs = None
    for a in range(num_subdivision):
        start_time = a * stride_time
        end_time = start_time + unit_time
        audio_start = math.floor(start_time / clip_length * len(clip_audio))
        in_audio = clip_audio[audio_start: audio_start + audio_sample_length]
        in_audio = np.pad(in_audio,
                          (0, audio_sample_length - len(in_audio)),
                          "constant")
        in_audio_t = torch.as_tensor(in_audio, dtype=torch.float32,
                                     device=device)[None]
        log_mel = mel_ops.log_mel_spectrogram(
            in_audio_t, sr=sr, n_fft=d.mel_n_fft, hop=d.mel_hop,
            n_mels=d.mel_bins)

        words = get_words_in_time_range(clip_words, start_time, end_time)
        frame_dur = unit_time / n_frames
        word_ids = np.zeros(n_frames, np.int64)
        if tokenizer is not None and d.use_hf_token_stream:
            # HF token ids scattered to the slot of the word at the same
            # position in the window (test_checkpoint.py:438-446)
            hf_ids = tokenizer(" ".join(w[0] for w in words))
            hf_ids = hf_ids[: d.max_text_tokens]
            for w_i, w in enumerate(words):
                if w_i >= len(hf_ids):
                    break
                idx = max(0, int(np.floor((w[1] - start_time) / frame_dur)))
                if idx < n_frames:
                    word_ids[idx] = hf_ids[w_i]
        else:
            for w in words:
                idx = max(0, int(np.floor((w[1] - start_time) / frame_dur)))
                if idx < n_frames:
                    word_ids[idx] = lang_model.get_word_index(w[0])
        text = torch.as_tensor(word_ids, device=device)[None]

        if a > 0:
            pre_seq = outputs[:, -d.n_seed_frames:]

        outputs = forward_fn(in_audio_t, log_mel, text, pre_seq, vid,
                             generator)
        out_seq = outputs[0].detach().cpu().numpy().copy()

        if out_list:
            # 4-frame linear cross-fade (test_checkpoint.py:462-471)
            last_poses = out_list[-1][-d.n_pre_poses:]
            out_list[-1] = out_list[-1][:-d.n_pre_poses]
            n = len(last_poses)
            for j in range(n):
                out_seq[j] = (last_poses[j] * (n - j) / (n + 1)
                              + out_seq[j] * (j + 1) / (n + 1))
        out_list.append(out_seq)

    return np.vstack(out_list)
