"""The model's inputs worked out again from the record store, in plain
numpy and PyTorch: the benchmark's check reads the same record files as the
port's input pipeline, and derives each batch here on its own.

Record store (two files a split): `<name>.idx`, (n + 1) int64 byte offsets;
`<name>.bin`, the magic b"HOPR0001", an int64 of the fixed bytes a record
holds, then records: pose_seq (F, J, 3), vec_seq (F, J - 1, 3), audio
(F / fps * 16000,), spectrogram (bins, frames) as little-endian f32, with
F = round(1.25 n_poses), then an int64 length and a JSON tail (the speaker
"vid", the timed "words", "start_time", "end_time").

A batch (reference data_loader/lmdb_data_loader.py): the first n_poses
frames of the direction vectors; the audio cut to its expected length; one
word id on evenly spaced frames (the words that start inside the clipped
window, in order, at every `int(n / (k + 1))`-th frame); the speaker's id;
the log-mel of the audio (librosa's melspectrogram and power_to_db).
Word ids follow the vocabulary in order of first appearance over the
records (0-3 are PAD, SOS, EOS, UNK); speaker ids start at 1.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

MAGIC = b"HOPR0001"


class Records:
    """A record store read with numpy."""

    def __init__(self, path: str, conf: dict):
        d = conf["data"]
        bones = conf["derived"]["pose_dim"] // 3
        n_ext = int(round(d["n_poses"] * 1.25))
        audio_len = int(n_ext / d["pose_resampling_fps"] * 16000)
        spec_len = int(round((n_ext / d["pose_resampling_fps"] * 16000 - 1024) / 512 + 1))
        self.fields = (("pose_seq", (n_ext, bones + 1, 3)), ("vec_seq", (n_ext, bones, 3)),
                       ("audio", (audio_len,)), ("spectrogram", (d["mel_bins"], spec_len)))
        self.raw = np.fromfile(path + ".bin", dtype=np.uint8)
        if self.raw[:8].tobytes() != MAGIC:
            raise ValueError(f"{path}.bin is not a record store")
        fixed = int(self.raw[8:16].view(np.int64)[0])
        if fixed != sum(4 * int(np.prod(s)) for _, s in self.fields):
            raise ValueError(f"{path}.bin holds records of {fixed} bytes, not this config's")
        self.offsets = np.fromfile(path + ".idx", dtype=np.int64)
        self.aux = [self._read(i)[1] for i in range(len(self))]

    def __len__(self):
        return len(self.offsets) - 1

    def _read(self, i: int):
        pos = 16 + int(self.offsets[i])
        arrays = {}
        for name, shape in self.fields:
            n = int(np.prod(shape))
            arrays[name] = self.raw[pos:pos + 4 * n].view("<f4").reshape(shape)
            pos += 4 * n
        tail = int(self.raw[pos:pos + 8].view(np.int64)[0])
        return arrays, json.loads(self.raw[pos + 8:pos + 8 + tail].tobytes())

    def n_speakers(self) -> int:
        """Rows of the speaker table: the speakers, and id 0."""
        return len(self.vocabularies()[1]) + 1

    def vocabularies(self):
        """(word -> id, speaker -> id) in order of first appearance."""
        words, vids = {}, {}
        for aux in self.aux:
            vids.setdefault(aux["vid"], len(vids) + 1)
            for w in aux["words"]:
                words.setdefault(w[0], len(words) + 4)
        return words, vids


def word_ids(aux: dict, n: int, n_ext: int, words: dict) -> np.ndarray:
    start = aux["start_time"]
    end = start + (aux["end_time"] - start) * n / n_ext
    frame = (end - start) / n
    ws = aux["words"]
    k = sum(1 for w in ws if max(0, int(math.floor((w[1] - start) / frame))) < n)
    space = int(n / (k + 1)) if k else 0
    out = np.zeros(n, np.int64)
    for i in range(k):
        out[(i + 1) * space] = words.get(ws[i][0], 3)
    return out


def host_batch(records: Records, indices, conf: dict) -> dict:
    """The numpy fields of a batch of the given record indices."""
    d = conf["data"]
    n, B = d["n_poses"], len(indices)
    n_ext = records.fields[0][1][0]
    words, vids = records.vocabularies()
    vec, audio = [], []
    text = np.zeros((B, n), np.int64)
    vid = np.zeros((B,), np.int64)
    for b, i in enumerate(indices):
        arrays, aux = records._read(int(i))
        vec.append(arrays["vec_seq"][:n].reshape(n, -1))
        audio.append(arrays["audio"][:d["expected_audio_length"]])
        text[b] = word_ids(aux, n, n_ext, words) % conf["llm"]["vocab_size"]
        vid[b] = vids[aux["vid"]]
    return {"target_vec": np.stack(vec), "in_audio": np.stack(audio),
            "text_padded": text, "vid_indices": vid}


# ---- log-mel (librosa 0.8: slaney mel scale and norm, periodic hann, centred
# reflect padding, power_to_db against each sample's maximum, top_db 80) ----

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = (200.0 / 3) * m
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, conf: dict) -> torch.Tensor:
    """(B, samples) -> (B, frames, mel_bins) log-mel."""
    d = conf["data"]
    n_fft, hop = d["mel_n_fft"], d["mel_hop"]
    x = torch.nn.functional.pad(audio[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(
        n_fft, dtype=torch.float64, device=audio.device) / n_fft))
    spec = torch.fft.rfft(frames.double() * window, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).float()
    fb = torch.from_numpy(mel_filters(d["sample_rate"], n_fft, d["mel_bins"])).to(audio.device)
    mel = power @ fb.t()
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    ref = torch.amax(mel, dim=(-2, -1), keepdim=True)
    db = db - 10.0 * torch.log10(torch.clamp(ref, min=1e-10))
    return torch.maximum(db, torch.amax(db, dim=(-2, -1), keepdim=True) - 80.0)


def device_batch(host: dict, conf: dict, device) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
    out["log_mel"] = log_mel(out["in_audio"], conf)
    return out
