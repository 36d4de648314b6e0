"""Serving export and long-form inference (port of hop_tpu/infer.py;
reference test_checkpoint.py:370-480).

`export_forward` writes the eval-mode generation forward of a HOPModel at
fixed shapes as a `torch.export` program, weights included, to bytes;
`load_exported` reads it back into a callable that runs without any model
code: it imports only the ops modules, which register the kernels'
forwards as `torch.ops.hop_tpu_torch.*` (K1, K2 or K3, K4 or K5), so the
loaded program launches the same CUDA kernels as the eager forward (on the
CPU, their plain versions). `compile_forward` is the same program kept in
memory. Three differences from the JAX artifact: the weights are inside
(JAX takes them as the first argument), the speaker latent's noise is an
input `eps` (B, z_size) where JAX takes a PRNG key, and a program runs on
the one device it was exported on.

`generate_long_form`: 34-frame windows at a 30-frame stride; each window
is seeded with the previous window's last 16 output frames; a 4-frame
linear cross-fade joins consecutive windows. The per-window log-mel is
computed on the device. The forward is any callable; `make_forward` wraps
a HOPModel, `make_exported_forward` a loaded program.
"""

from __future__ import annotations

import io
import math
from typing import Callable, Optional

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.data.preprocessor import get_words_in_time_range
from hop_tpu_torch.ops import mel as mel_ops


def register_ops() -> None:
    """Import the modules that register `torch.ops.hop_tpu_torch.*` (the
    kernels' forwards); a saved program refers to them by name."""
    from hop_tpu_torch.ops import (attention, block_attention,  # noqa: F401
                                   gru_fused, gru_stack, reprogramming_attention)


def serving_inputs(cfg: Config, batch_size: int = 1,
                   device: torch.device | str = "cuda") -> tuple:
    """Zero tensors of the serving forward's fixed argument shapes (hop_tpu
    `_forward_and_shapes`): audio (B, int(n_poses / fps * sr)), log-mel
    (B, n_poses, mel_bins), text ids (B, n_poses), pre_seq (B,
    n_seed_frames, pose_dim), speaker ids (B,), and the speaker latent's
    noise eps (B, z_size) in place of JAX's PRNG key."""
    d, B = cfg.data, batch_size
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return (torch.zeros((B, int(d.n_poses / d.pose_resampling_fps * d.sample_rate)), **f32),
            torch.zeros((B, d.n_poses, d.mel_bins), **f32),
            torch.zeros((B, d.n_poses), **i64),
            torch.zeros((B, d.n_seed_frames, d.pose_dim), **f32),
            torch.zeros((B,), **i64),
            torch.zeros((B, cfg.hop.z_size), **f32))


class _ServingForward(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, in_audio, log_mel, text, pre_seq, vid, eps):
        out, *_ = self.model(in_audio, log_mel, text, pre_seq, vid, eps=eps)
        return out


def export_program(model, cfg: Config, batch_size: int = 1,
                   device: torch.device | str = "cuda"):
    """`torch.export.export` of the eval-mode forward under no_grad, at the
    shapes of `serving_inputs`; the model must lie on `device`. The model's
    train mode is restored after."""
    device = torch.device(device)
    if any(p.device.type != device.type for p in model.parameters()):
        raise ValueError(f"the model does not lie on {device}: a program runs "
                         "on the one device it was exported on")
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_ServingForward(model),
                                       serving_inputs(cfg, batch_size, device))
    finally:
        model.train(was_training)


class ExportedForward:
    """A serving program as a callable (in_audio, log_mel, text, pre_seq,
    vid, eps) -> (B, n_poses, pose_dim), run under no_grad at the shapes it
    was exported at, on its device."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()
        vals = [n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder"
                and n.name in program.graph_signature.user_inputs]
        self.device = vals[0].device
        self.eps_shape = tuple(vals[-1].shape)

    def __call__(self, in_audio, log_mel, text, pre_seq, vid, eps):
        with torch.no_grad():
            return self._module(in_audio, log_mel, text, pre_seq, vid, eps)

    def call_targets(self) -> set:
        """Names of the operators the program's graph calls."""
        return {str(n.target) for n in self.program.graph.nodes
                if n.op == "call_function"}


def compile_forward(model, cfg: Config, batch_size: int = 1,
                    device: torch.device | str = "cuda") -> ExportedForward:
    """The exported program of `export_forward`, kept in memory: a
    fixed-shape callable (not torch.compile)."""
    return ExportedForward(export_program(model, cfg, batch_size, device))


def export_forward(model, cfg: Config, batch_size: int = 1,
                   device: torch.device | str = "cuda") -> bytes:
    """The serving program (`export_program`), weights included, as the
    bytes `torch.export.save` writes; the zero inputs it was traced with
    are left out (37 MB of audio at bs 256)."""
    program = export_program(model, cfg, batch_size, device)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> ExportedForward:
    """An `export_forward` artifact as a callable (in_audio, log_mel, text,
    pre_seq, vid, eps) -> (B, n_poses, pose_dim). Only the ops modules are
    imported, no model code."""
    register_ops()
    return ExportedForward(torch.export.load(io.BytesIO(blob)))


def make_exported_forward(loaded: ExportedForward) -> Callable:
    """forward_fn for `generate_long_form` from a loaded program: eps is
    drawn from the caller's generator as the eager SpeakerLatent draws it,
    so the same generator gives the same noise on both."""
    def forward(in_audio, log_mel, text, pre_seq, vid, generator):
        eps = torch.randn(loaded.eps_shape, generator=generator,
                          dtype=torch.float32, device=in_audio.device)
        return loaded(in_audio, log_mel, text, pre_seq, vid, eps)
    return forward


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
