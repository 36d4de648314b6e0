"""The trimodal-context generator and the discriminator of the HOP GAN and
of the trimodal GAN (port of hop_tpu/models/multimodal_context.py's
PoseGenerator :21-78 and ConvDiscriminator :106-130; reference
model/multimodal_context_net.py:66-172, 219-268).

PoseGenerator: the seed poses with their indicator bit (pose_dim + 1), the
WavEncoder's audio features (32) and the TextEncoderTCN's word features
(32), as `input_context` selects them, and the speaker latent z (16) go
through a 4-layer BiGRU(300) with inter-layer dropout 0.3 (kernel K2 or K3
on CUDA); its two directions are summed, then Linear(150), the reference's
identity LeakyReLU and Linear(pose_dim). Children carry the reference's
names (`audio_encoder.feat_extractor.*`, `text_encoder.*`,
`speaker_embedding.*`, `speaker_mu`, `speaker_logvar`, `gru.*`,
`out.{0,2}`), which hop_tpu's `convert_pose_generator` reads.

ConvDiscriminator:
Conv1d pose_dim -> 16 -> 8 -> 8 (kernel 3, valid: T 34 -> 28) with
BatchNorm and the reference's identity LeakyReLU between, a 4-layer
BiGRU(64) with inter-layer dropout 0.3 (kernel K2 or K3 on CUDA), a per-step
Linear(64, 1) and a Linear(28, 1) over time, then a sigmoid. Children
carry the reference's names (`pre_conv.{0,1,3,4,6}`, `gru.*`, `out`,
`out2`), which `hop_tpu.eval.torch_import_generator.
convert_conv_discriminator` reads. BatchNorm follows flax's training rule
(`common.batch_norm`).

Discriminator (hop_tpu :80-104, reference :175-216): the text-conditioned
BiGRU discriminator, the poses and (with `n_words`) a TextEncoderTCN's word
features through a 4-layer BiGRU(300), a per-step Linear(1) and a Linear
over time, then a sigmoid. No entry point builds it; it is here for the
reference's checkpoints (`text_encoder.*`, `gru.*`, `out`, `out2`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.models import common
from hop_tpu_torch.models.tcn import TextEncoderTCN
from hop_tpu_torch.ops.gru import GRU

HIDDEN = 64
INPUT_CONTEXTS = ("both", "audio", "text", "none")


class PoseGenerator(common.SpeakerLatent):
    """(pre_seq (B, T, pose_dim + 1), word ids (B, T), raw audio (B, n),
    speaker ids (B,)) -> (poses (B, T, pose_dim), z, mu, logvar)."""

    def __init__(self, pose_dim: int, n_words: int, n_speakers: int,
                 hidden_size: int = 300, n_layers: int = 4, dropout: float = 0.3,
                 input_context: str = "both", z_size: int = 16,
                 gru_kernel: str = "fused", gru_bf16_streams: bool = False):
        super().__init__(n_speakers, z_size)
        if input_context not in INPUT_CONTEXTS:
            raise ValueError(f"input_context must be one of {INPUT_CONTEXTS}, "
                             f"got {input_context!r}")
        self.input_context = input_context
        in_size = pose_dim + 1 + z_size
        if input_context in ("both", "audio"):
            self.audio_encoder = common.WavEncoder()
            in_size += 32
        if input_context in ("both", "text"):
            self.text_encoder = TextEncoderTCN(n_words, channels=(hidden_size,) * n_layers,
                                               dropout=dropout)
            in_size += 32
        self.hidden_size = hidden_size
        self.gru = GRU(in_size, hidden_size, num_layers=n_layers,
                       bidirectional=True, dropout=dropout, kernel=gru_kernel,
                       bf16_streams=gru_bf16_streams)
        self.out = nn.Sequential(nn.Linear(hidden_size, hidden_size // 2),
                                 nn.LeakyReLU(common.IDENTITY_SLOPE),
                                 nn.Linear(hidden_size // 2, pose_dim))

    def forward(self, pre_seq: torch.Tensor, in_text: torch.Tensor,
                in_audio: torch.Tensor, vid_indices: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """`generator` draws the dropout masks (training mode) and, unless
        `eps` is given, the speaker noise."""
        feats = [pre_seq]
        if self.input_context in ("both", "audio"):
            feats.append(self.audio_encoder(in_audio))
        if self.input_context in ("both", "text"):
            feats.append(self.text_encoder(in_text, generator))
        z, mu, logvar = self.speaker(vid_indices, generator, eps)
        T = pre_seq.shape[1]
        feats.append(z[:, None].expand(-1, T, -1))
        out, _ = self.gru(torch.cat(feats, dim=-1), generator)
        H = self.hidden_size
        return self.out(out[..., :H] + out[..., H:]), z, mu, logvar


def build_pose_generator(cfg, n_words: int, n_speakers: int, seed: int,
                         device: torch.device | str = "cuda") -> PoseGenerator:
    """PoseGenerator at `cfg.baseline`'s widths on `cfg.hop`'s GRU route,
    initialised from `seed` on the host, moved to `device`; the caller's
    global RNG state is left as it was."""
    b = cfg.baseline
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = PoseGenerator(cfg.data.pose_dim, n_words, n_speakers, b.hidden_size,
                            b.n_layers, b.dropout_prob, b.input_context,
                            gru_kernel=cfg.hop.gru_kernel,
                            gru_bf16_streams=cfg.hop.gru_bf16_streams)
    return gen.to(device)


class ConvDiscriminator(nn.Module):
    """(B, n_poses, pose_dim) poses -> (B, 1) probability of being real."""

    def __init__(self, pose_dim: int, n_poses: int = 34,
                 gru_kernel: str = "fused", gru_bf16_streams: bool = False):
        super().__init__()
        self.pre_conv = nn.Sequential(
            nn.Conv1d(pose_dim, 16, 3),
            common.BatchNorm1d(16),
            nn.LeakyReLU(common.IDENTITY_SLOPE),
            nn.Conv1d(16, 8, 3),
            common.BatchNorm1d(8),
            nn.LeakyReLU(common.IDENTITY_SLOPE),
            nn.Conv1d(8, 8, 3))
        self.gru = GRU(8, HIDDEN, num_layers=4, bidirectional=True, dropout=0.3,
                       kernel=gru_kernel, bf16_streams=gru_bf16_streams)
        self.out = nn.Linear(HIDDEN, 1)
        self.out2 = nn.Linear(n_poses - 6, 1)

    def forward(self, poses: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the GRU's dropout masks in training mode."""
        x = self.pre_conv(poses.transpose(1, 2)).transpose(1, 2)   # (B, 28, 8)
        out, _ = self.gru(x, generator)
        out = out[..., :HIDDEN] + out[..., HIDDEN:]
        out = self.out(out)[..., 0]                                # (B, 28)
        return torch.sigmoid(self.out2(out))                       # (B, 1)


def build_discriminator(cfg, seed: int,
                        device: torch.device | str = "cuda") -> ConvDiscriminator:
    """ConvDiscriminator for `cfg`'s poses and GRU route with torch's default
    initialisation drawn from `seed` (on the host), moved to `device`. The
    global RNG state of the caller is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses,
                                 cfg.hop.gru_kernel, cfg.hop.gru_bf16_streams)
    return disc.to(device)


class Discriminator(nn.Module):
    """(poses (B, n_poses, input_size), word ids (B, n_poses) or None) -> (B,
    1) probability of being real."""

    def __init__(self, input_size: int, n_poses: int = 34, hidden_size: int = 300,
                 n_layers: int = 4, dropout: float = 0.3, n_words: Optional[int] = None,
                 gru_kernel: str = "fused"):
        super().__init__()
        self.hidden_size = hidden_size
        self.text_encoder = None
        if n_words is not None:
            self.text_encoder = TextEncoderTCN(n_words)
            input_size += 32
        self.gru = GRU(input_size, hidden_size, num_layers=n_layers, bidirectional=True,
                       dropout=dropout, kernel=gru_kernel)
        self.out = nn.Linear(hidden_size, 1)
        self.out2 = nn.Linear(n_poses, 1)

    def forward(self, poses: torch.Tensor, in_text: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = poses
        if self.text_encoder is not None:
            x = torch.cat([x, self.text_encoder(in_text, generator)], dim=-1)
        out, _ = self.gru(x, generator)
        H = self.hidden_size
        return torch.sigmoid(self.out2(self.out(out[..., :H] + out[..., H:])[..., 0]))
