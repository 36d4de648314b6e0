"""Audio onset detection (librosa-compatible) for beat consistency, on the
tensor's device (port of hop_tpu/ops/onset.py).

Replaces the reference's per-sample host round-trip through
librosa.onset.onset_detect inside the eval loop (reference
Evaluate.py:207,250) with a batched implementation on the port's
matrix-product mel frontend (ops/mel.py). Parameters are pinned to what
librosa 0.8.1 resolves for onset_detect(y, sr=16000, units='time'):

  onset_strength: mel spectrogram n_fft=2048, hop=512, n_mels=128,
                  fmax=11025.0 (librosa onset_strength_multi's hardcoded
                  melspectrogram default — NOT sr/2; for sr=16000 the top
                  mel triangles fall beyond the Nyquist bins and read 0),
                  power_to_db(ref=1.0), spectral flux lag=1, mean
                  aggregate, centered (lag + n_fft//(2*hop) leading
                  zeros, then truncate)
  normalisation:  envelope -> (env - min) / max
  peak_pick:      pre_max=0.03*sr//hop, post_max=1, pre_avg=0.10*sr//hop,
                  post_avg=pre_avg+1, wait=0.03*sr//hop, delta=0.07
                  (for sr=16000/hop=512: 0, 1, 3, 4, 0, 0.07)

For sr=16000/hop=512, pre_max=0/post_max=1 make the max filter the
identity and wait=0 makes the suppression a no-op, so peak picking is a
threshold against the 7-tap moving average; the general max filter and
the wait suppression (a loop over frames, vectorised over the batch, as
hop_tpu's `lax.scan`) are kept so other rates stay exact too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hop_tpu_torch.ops import mel as mel_ops

# librosa onset_strength_multi: kwargs.setdefault('fmax', 11025.0)
ONSET_FMAX = 11025.0


def onset_strength(audio: torch.Tensor, sr: int = 16000, hop: int = 512,
                   n_fft: int = 2048, n_mels: int = 128) -> torch.Tensor:
    """(..., n_samples) -> (..., n_frames) spectral-flux onset envelope."""
    power = mel_ops.power_spectrogram(audio, n_fft=n_fft, hop=hop)
    fb = torch.from_numpy(mel_ops.mel_filterbank(sr, n_fft, n_mels,
                                                 fmax=ONSET_FMAX)).to(power.device)
    s = power @ fb.T  # (..., frames, mels)
    # power_to_db with ref=1.0 (librosa onset_strength default)
    s_db = 10.0 * torch.log10(torch.clamp(s, min=1e-10))
    top = torch.amax(s_db, dim=(-2, -1), keepdim=True) - 80.0
    s_db = torch.maximum(s_db, top)
    flux = torch.clamp(s_db[..., 1:, :] - s_db[..., :-1, :], min=0.0)
    env = torch.mean(flux, dim=-1)  # (..., frames-1)
    env = F.pad(env, (1 + n_fft // (2 * hop), 0))
    return env[..., :s.shape[-2]]


def _moving_average(x: torch.Tensor, pre: int, post: int) -> torch.Tensor:
    """mean(x[n-pre : n+post]) with truncation at both edges (librosa
    peak_pick's corrected uniform filter)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    starts = torch.clamp(idx - pre, min=0)
    ends = torch.clamp(idx + post, max=n)  # exclusive
    csum = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    totals = csum[..., ends] - csum[..., starts]
    return totals / (ends - starts)


def _moving_max(x: torch.Tensor, pre: int, post: int) -> torch.Tensor:
    """max(x[n-pre : n+post]): scipy maximum_filter1d(mode=constant, cval=0,
    origin=ceil(0.5*(pre-post))) as librosa uses it (truncation fills 0)."""
    if pre + post <= 1:
        return x
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    outs = []
    for off in range(-pre, post):
        shifted = torch.roll(x, -off, dims=-1)
        valid = (idx + off >= 0) & (idx + off < n)
        outs.append(torch.where(valid, shifted, torch.zeros_like(shifted)))
    return torch.amax(torch.stack(outs, dim=0), dim=0)


def _wait_suppress(mask: torch.Tensor, wait: int) -> torch.Tensor:
    """librosa peak_pick's greedy suppression: walk detections in time
    order, keep frame i only if i > last_kept + wait. A no-op for wait=0
    (distinct indices always satisfy i > last). A loop over frames,
    vectorised over the leading axes."""
    if wait <= 0:
        return mask
    last_kept = torch.full(mask.shape[:-1], -(wait + 1), dtype=torch.int32,
                           device=mask.device)
    kept = []
    for i in range(mask.shape[-1]):
        keep = mask[..., i] & (i > last_kept + wait)
        last_kept = torch.where(keep, torch.full_like(last_kept, i), last_kept)
        kept.append(keep)
    return torch.stack(kept, dim=-1)


def peak_pick_mask(env: torch.Tensor, sr: int = 16000, hop: int = 512,
                   delta: float = 0.07) -> torch.Tensor:
    """librosa peak_pick on a normalised envelope -> boolean frame mask.

    Parameters resolve exactly as librosa onset_detect's defaults (float
    floor-division then int(), librosa 0.8.1 onset.py); frame i is an onset
    iff env[i] equals the local max, env[i] >= truncated moving average +
    delta, and the greedy wait suppression keeps it.
    """
    pre_max = int(0.03 * sr // hop)
    post_max = int(0.00 * sr // hop + 1)
    pre_avg = int(0.10 * sr // hop)
    post_avg = int(0.10 * sr // hop + 1)
    wait = int(0.03 * sr // hop)

    mov_max = _moving_max(env, pre_max, post_max)
    mov_avg = _moving_average(env, pre_avg, post_avg)
    detections = env * (env == mov_max)
    mask = detections >= (mov_avg + delta)
    return _wait_suppress(mask, wait)


def onset_detect_mask(audio: torch.Tensor, sr: int = 16000, hop: int = 512,
                      delta: float = 0.07) -> torch.Tensor:
    """Boolean onset mask per frame, (..., n_frames) — librosa 0.8.1
    onset_detect(y, sr, units='frames') as a mask."""
    env = onset_strength(audio, sr=sr, hop=hop)
    env = env - torch.amin(env, dim=-1, keepdim=True)
    mx = torch.amax(env, dim=-1, keepdim=True)
    env = torch.where(mx > 0, env / torch.where(mx > 0, mx, torch.ones_like(mx)), env)
    return peak_pick_mask(env, sr=sr, hop=hop, delta=delta)


def onset_frame_times(n_frames: int, sr: int = 16000, hop: int = 512,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.arange(n_frames, device=device) * (hop / sr)
