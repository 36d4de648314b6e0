"""Log-mel spectrogram frontend as matrix products (port of hop_tpu/ops/mel.py).

Frame -> windowed real DFT as two matmuls -> mel projection as a third
matmul -> power_to_db, all in f32 on the tensor's device. The JAX package
leaves these to XLA outside any Pallas kernel, so they stay plain PyTorch
here. Semantics match librosa 0.8.1:
  * stft: periodic hann window, center=True with reflect padding, |.|^2
  * mel filterbank: slaney scale, slaney area normalisation, fmin=0,
    fmax=sr/2
  * power_to_db: ref = per-sample max, amin=1e-10, top_db=80
`extract_melspectrogram` is the record store's cached spectrogram (hop 512).

The numpy table builders are copies of hop_tpu/ops/mel.py:26-84 (that
module imports jax). Each table goes to a device once, from pinned memory
and asynchronously (`_on_device`): a copy per call from pageable memory
made the host wait for the card inside the training loop's batch path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int = 16000, n_fft: int = 1024, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) slaney-normalised triangular filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_window_matrices(n_fft: int):
    """Windowed real DFT as (n_fft, n_bins) cos/sin matrices, with the
    periodic hann window folded in."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=None)
def _on_device(table: str, device: torch.device, *args) -> tuple:
    """The numpy tables `table` ("dft": cos and sin, or "mel": the
    filterbank) of `args` as tensors on `device`, made once."""
    arrays = (_dft_window_matrices(*args) if table == "dft"
              else (mel_filterbank(*args),))
    out = tuple(torch.from_numpy(a) for a in arrays)
    if device.type == "cuda":
        out = tuple(t.pin_memory().to(device, non_blocking=True) for t in out)
    return out


def frame_signal(y: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """(..., n_samples) -> (..., n_frames, n_fft), librosa centering."""
    if center:
        lead = y.shape[:-1]
        flat = y.reshape(-1, 1, y.shape[-1])
        flat = F.pad(flat, (n_fft // 2, n_fft // 2), mode="reflect")
        y = flat.reshape(*lead, flat.shape[-1])
    return y.unfold(-1, n_fft, hop)


def power_spectrogram(y: torch.Tensor, n_fft: int = 1024, hop: int = 512,
                      center: bool = True) -> torch.Tensor:
    """|STFT|^2 as (..., n_frames, n_bins) via matmul DFT."""
    frames = frame_signal(y.float(), n_fft, hop, center)
    cos_m, sin_m = _on_device("dft", frames.device, n_fft)
    re = frames @ cos_m
    im = frames @ sin_m
    return re * re + im * im


def power_to_db(s: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0,
                ref_axes: tuple | None = None) -> torch.Tensor:
    """librosa.power_to_db with ref=max over `ref_axes` (default: all axes).
    Batched callers pass ref_axes=(-2, -1): each sample normalises by its
    own max."""
    if ref_axes is None:
        ref_axes = tuple(range(s.ndim))
    ref = torch.amax(s, dim=ref_axes, keepdim=True)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        peak = torch.amax(log_spec, dim=ref_axes, keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def log_mel_spectrogram(audio: torch.Tensor, sr: int = 16000,
                        n_fft: int = 1024, hop: int = 1096,
                        n_mels: int = 128) -> torch.Tensor:
    """(..., n_samples) -> (..., n_frames, n_mels) log-mel, frames-first.
    A 36267-sample window at hop 1096 yields exactly 34 frames."""
    power = power_spectrogram(audio, n_fft=n_fft, hop=hop)
    fb, = _on_device("mel", power.device, sr, n_fft, n_mels)
    mel = power @ fb.T
    return power_to_db(mel, ref_axes=(-2, -1))


def extract_melspectrogram(y: torch.Tensor, sr: int = 16000) -> torch.Tensor:
    """The record store's cached spectrogram, (..., mels, frames) at n_fft
    1024 and hop 512 (reference data_utils.py:34-38)."""
    return log_mel_spectrogram(y, sr=sr, n_fft=1024, hop=512).transpose(-1, -2)
