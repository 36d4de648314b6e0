"""Host batch -> device batch (port of hop_tpu/cli/common.py:318-396).

`device_batch` takes a batch of numpy arrays as the data loader makes it,
moves the fields a model reads to the device and derives there what the
model needs beside them: the per-sample log-mel from the raw audio, the
word mask, and the text ids clamped into the backbone's vocabulary. Raw
audio, the batch's largest field, can cross at 16 bits
(`DataConfig.audio_wire="int16"`). Every host array goes through pinned
memory in one explicit asynchronous copy.
"""

from __future__ import annotations

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.ops import mel as mel_ops

#: host fields each model family reads; transferring only these cuts the
#: per-batch host-to-device volume (AD_LLM skips the spectrogram and the
#: pose_seq/word streams)
MODEL_BATCH_KEYS = {
    "AD_LLM": ("in_audio", "target_vec", "vid_indices", "text_padded",
               "text_tokens"),
}


def _put(array: np.ndarray, device) -> torch.Tensor:
    """One host array to `device`: from pinned memory, asynchronously, when
    that is a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _put_audio(audio: np.ndarray, wire: str, device) -> torch.Tensor:
    """Transfer raw audio at the configured wire dtype (DataConfig.audio_wire).

    "int16" quantizes on the host to the 16-bit PCM grid (i / 2^15) and
    dequantizes on the device, halving the volume of the batch's dominant
    tensor. Exact for PCM-derived audio; <= 2^-16 full-scale error and
    [-1, 1) saturation otherwise. The model always sees float32.
    """
    if wire == "int16":
        q = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
        return _put(q, device).to(torch.float32) * (1.0 / 32768.0)
    if wire != "f32":
        raise ValueError(f"audio_wire must be 'f32' or 'int16', got {wire!r}")
    return _put(audio, device)


def device_batch(batch: dict, cfg: Config, with_mel: bool = True, keys=None,
                 device: torch.device | str = "cuda") -> dict:
    """Host batch (numpy arrays) -> tensors on `device` + log-mel computed
    there.

    keys: optional subset of host fields to transfer (MODEL_BATCH_KEYS);
    derived tensors (log_mel, text_mask, the text_padded clamp) are computed
    when their sources are present.
    """
    if keys is not None:
        batch = {k: v for k, v in batch.items() if k in keys}
    # text ids are transferred once, after the clamp (below), not here too
    out = {k: _put(np.asarray(v), device) for k, v in batch.items()
           if k not in ("text_padded", "text_tokens", "in_audio")}
    if "in_audio" in batch:
        out["in_audio"] = _put_audio(np.asarray(batch["in_audio"]),
                                     cfg.data.audio_wire, device)
    if with_mel and "in_audio" in out:
        d = cfg.data
        out["log_mel"] = mel_ops.log_mel_spectrogram(
            out["in_audio"], sr=d.sample_rate, n_fft=d.mel_n_fft,
            hop=d.mel_hop, n_mels=d.mel_bins)
    if "word_seq" in batch and "text_lengths" in batch:
        T = batch["word_seq"].shape[1]
        out["text_mask"] = _put(
            (np.arange(T)[None] < np.asarray(batch["text_lengths"])[:, None])
            .astype(np.float32), device)
    # the live HOP path feeds vocabulary word ids as LLM token ids
    # (run_ted.py:400), clamped into the LLM vocabulary on the host;
    # use_hf_token_stream switches to the HF tokenizer's ids instead
    if cfg.data.use_hf_token_stream and "text_tokens" in batch:
        out["text_padded"] = _put(
            np.asarray(batch["text_tokens"]) % cfg.llm.vocab_size, device)
    elif "text_padded" in batch:
        out["text_padded"] = _put(
            np.asarray(batch["text_padded"]) % cfg.llm.vocab_size, device)
    return out
