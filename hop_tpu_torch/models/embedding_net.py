"""Joint embedding network and gesture autoencoder (port of
hop_tpu/models/embedding_net.py; reference model/embedding_net.py:16-316).
In pose mode (PoseEncoderConv + PoseDecoderConv) it is the TED feature net
of FGD, loaded frozen by EmbeddingSpaceEvaluator.py:407-410, and what
`gesture_autoencoder` trains on TED; in any other mode (`joint_embedding`)
it adds the ContextEncoder (TextEncoderTCN + WavEncoder -> GRU(256) x 2,
one direction: kernel K2 or K3 on CUDA) and decodes with PoseDecoderGRU
(seed poses + latent -> 4-layer BiGRU(300), inter-layer dropout 0.3).
PoseDecoderFC, the MLP decoder, is kept for the reference's checkpoints
(hop_tpu keeps it too; no entry point builds it).

Modules carry the reference's torch names (`pose_encoder.net.{i}.0/1`,
`pose_encoder.out_net.*`, `fc_mu`, `fc_logvar`, `decoder.pre_net.*`,
`decoder.net.*`), so `hop_tpu.eval.torch_import.convert_embedding_net_pose`
reads this module's state_dict as it reads the reference checkpoint.
Poses enter and leave feature-last, (B, T, pose_dim), as in hop_tpu; the
convolutions run in torch's (B, C, T) layout. BatchNorm is the port's
(`models.common.BatchNorm1d`), in eval mode for the frozen net. The other
modes' modules have no importer in hop_tpu; they carry the reference's
names (`context_encoder.{text_encoder,audio_encoder,gru,out,fc_mu,
fc_logvar}`, `decoder.{pre_pose_net,gru,out}`). The context latent's noise
comes from the generator handed to `forward`, or from a given `eps`; the
poses' latent is their mean, as the reference's training hardcodes
(variational_encoding=False, train_joint_embed.py:11-14).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.models import common
from hop_tpu_torch.models.tcn import TextEncoderTCN
from hop_tpu_torch.ops.gru import GRU


class ConvNormRelu(nn.Sequential):
    """Conv1d + BatchNorm + LeakyReLU(0.2) (reference embedding_net.py:16-39):
    children 0, 1, 2."""

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = False):
        k, s = (4, 2) if downsample else (3, 1)
        super().__init__(nn.Conv1d(in_channels, out_channels, k, stride=s),
                         common.BatchNorm1d(out_channels), nn.LeakyReLU(0.2))


def _leaky_identity() -> nn.Module:
    # the reference's nn.LeakyReLU(True): slope 1.0, the identity
    return nn.LeakyReLU(common.IDENTITY_SLOPE)


class PoseEncoderConv(nn.Module):
    """(B, 34, pose_dim) -> 32-d latent, with mu/logvar heads (reference
    embedding_net.py:42-84). The latent is mu."""

    def __init__(self, pose_dim: int, latent_dim: int = 32):
        super().__init__()
        self.net = nn.Sequential(
            ConvNormRelu(pose_dim, 32),                  # T 34 -> 32
            ConvNormRelu(32, 64),                        # -> 30
            ConvNormRelu(64, 64, downsample=True),       # -> 14
            nn.Conv1d(64, 32, 3))                        # -> 12 (12*32 = 384)
        self.out_net = nn.Sequential(
            nn.Linear(384, 256), common.BatchNorm1d(256), _leaky_identity(),
            nn.Linear(256, 128), common.BatchNorm1d(128), _leaky_identity(),
            nn.Linear(128, latent_dim))
        self.fc_mu = nn.Linear(latent_dim, latent_dim)
        self.fc_logvar = nn.Linear(latent_dim, latent_dim)

    def forward(self, poses: torch.Tensor):
        x = self.net(poses.transpose(1, 2)).flatten(1)   # channel-major
        x = self.out_net(x)
        mu = self.fc_mu(x)
        return mu, mu, self.fc_logvar(x)


class PoseDecoderConv(nn.Module):
    """Latent -> (B, 34, pose_dim) through transposed convolutions (reference
    embedding_net.py:167-219, without seed poses)."""

    def __init__(self, length: int, pose_dim: int, latent_dim: int = 32):
        super().__init__()
        assert length == 34, "the reference supports 34 (and 64) frames"
        self.pre_net = nn.Sequential(
            nn.Linear(latent_dim, 64), common.BatchNorm1d(64), _leaky_identity(),
            nn.Linear(64, 136))
        self.net = nn.Sequential(
            nn.ConvTranspose1d(4, 32, 3), common.BatchNorm1d(32), nn.LeakyReLU(0.2),
            nn.ConvTranspose1d(32, 32, 3), common.BatchNorm1d(32), nn.LeakyReLU(0.2),
            nn.Conv1d(32, 32, 3), nn.Conv1d(32, pose_dim, 3))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.pre_net(feat).view(feat.shape[0], 4, -1)   # (B, 4, 34)
        return self.net(x).transpose(1, 2)


def _pre_pose_net(n_pre_poses: int, pose_dim: int) -> nn.Sequential:
    """Seed poses -> 32: Linear, BatchNorm, ReLU, Linear."""
    return nn.Sequential(nn.Linear(n_pre_poses * pose_dim, 32), common.BatchNorm1d(32),
                         nn.ReLU(), nn.Linear(32, 32))


class PoseDecoderFC(nn.Module):
    """Latent (+ seed poses) -> an MLP of widths 128, 128, 256, 512 (each
    with BatchNorm and ReLU) -> (B, gen_length, pose_dim) (reference
    embedding_net.py:87-129)."""

    def __init__(self, gen_length: int, pose_dim: int, latent_dim: int = 32,
                 use_pre_poses: bool = False, n_pre_poses: int = 4):
        super().__init__()
        self.gen_length, self.pose_dim = gen_length, pose_dim
        self.use_pre_poses = use_pre_poses
        in_size = latent_dim
        if use_pre_poses:
            self.pre_pose_net = _pre_pose_net(n_pre_poses, pose_dim)
            in_size += 32
        layers = []
        for width in (128, 128, 256, 512):
            layers += [nn.Linear(in_size, width), common.BatchNorm1d(width), nn.ReLU()]
            in_size = width
        self.net = nn.Sequential(*layers, nn.Linear(512, gen_length * pose_dim))

    def forward(self, latent, pre_poses=None):
        feat = latent
        if self.use_pre_poses:
            feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)), latent], dim=1)
        return self.net(feat).view(-1, self.gen_length, self.pose_dim)


class PoseDecoderGRU(nn.Module):
    """Latent (32) + seed poses -> a 4-layer BiGRU(300) over gen_length
    steps -> (B, gen_length, pose_dim) (reference embedding_net.py:132-164)."""

    def __init__(self, gen_length: int, pose_dim: int, n_pre_poses: int = 4,
                 gru_kernel: str = "fused", gru_bf16_streams: bool = False):
        super().__init__()
        self.gen_length, self.hidden_size = gen_length, 300
        self.pre_pose_net = _pre_pose_net(n_pre_poses, pose_dim)
        self.gru = GRU(32 + 32, 300, num_layers=4, bidirectional=True, dropout=0.3,
                       kernel=gru_kernel, bf16_streams=gru_bf16_streams)
        self.out = nn.Sequential(nn.Linear(300, 150), _leaky_identity(),
                                 nn.Linear(150, pose_dim))

    def forward(self, latent, pre_poses, generator: Optional[torch.Generator] = None):
        feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)), latent], dim=1)
        out, _ = self.gru(feat[:, None].expand(-1, self.gen_length, -1), generator)
        H = self.hidden_size
        return self.out(out[..., :H] + out[..., H:])


class ContextEncoder(nn.Module):
    """Word ids + raw audio -> TextEncoderTCN (32) and WavEncoder (32) ->
    GRU(256) x 2, one direction -> its last step -> Linear(128), BatchNorm,
    ReLU, Linear(32) -> (z, mu, logvar) (reference embedding_net.py:222-261)."""

    def __init__(self, n_words: int, gru_kernel: str = "fused",
                 gru_bf16_streams: bool = False):
        super().__init__()
        self.text_encoder = TextEncoderTCN(n_words)
        self.audio_encoder = common.WavEncoder()
        self.gru = GRU(32 + 32, 256, num_layers=2, kernel=gru_kernel,
                       bf16_streams=gru_bf16_streams)
        self.out = nn.Sequential(nn.Linear(256, 128), common.BatchNorm1d(128), nn.ReLU(),
                                 nn.Linear(128, 32))
        self.fc_mu = nn.Linear(32, 32)
        self.fc_logvar = nn.Linear(32, 32)

    def forward(self, in_text, in_audio, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        x = torch.cat([self.audio_encoder(in_audio),
                       self.text_encoder(in_text, generator)], dim=-1)
        out, _ = self.gru(x, generator)
        h = self.out(out[:, -1])
        mu, logvar = self.fc_mu(h), self.fc_logvar(h)
        return common.reparameterize(mu, logvar, generator, eps), mu, logvar


class EmbeddingNet(nn.Module):
    """reference embedding_net.EmbeddingNet (:264-316). Mode "pose":
    PoseEncoderConv + PoseDecoderConv, the FGD feature net; any other mode
    adds the ContextEncoder and decodes with PoseDecoderGRU."""

    def __init__(self, pose_dim: int, n_frames: int, n_words: int,
                 mode: str = "pose", n_pre_poses: int = 4,
                 gru_kernel: str = "fused", gru_bf16_streams: bool = False):
        super().__init__()
        self.mode = mode
        if mode != "pose":
            self.context_encoder = ContextEncoder(n_words, gru_kernel, gru_bf16_streams)
            self.decoder = PoseDecoderGRU(n_frames, pose_dim, n_pre_poses, gru_kernel,
                                          gru_bf16_streams)
        else:
            self.decoder = PoseDecoderConv(n_frames, pose_dim)
        self.pose_encoder = PoseEncoderConv(pose_dim)

    def forward(self, in_text, in_audio, pre_poses, poses,
                input_mode: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """hop_tpu's 7-tuple: (context_feat, context_mu, context_logvar,
        poses_feat, pose_mu, pose_logvar, out_poses). The context entries
        are None in pose mode or without text and audio; the decoder reads
        the context's latent when `input_mode` is "speech", else the poses'.
        `generator` draws the dropout masks (training mode) and, unless `eps`
        is given, the context latent's noise."""
        input_mode = input_mode or self.mode
        context_feat = context_mu = context_logvar = None
        if self.mode != "pose" and in_text is not None and in_audio is not None:
            context_feat, context_mu, context_logvar = self.context_encoder(
                in_text, in_audio, generator, eps)
        poses_feat = pose_mu = pose_logvar = None
        if poses is not None:
            poses_feat, pose_mu, pose_logvar = self.pose_encoder(poses)
        latent = context_feat if input_mode == "speech" else poses_feat
        if self.mode != "pose":
            out_poses = self.decoder(latent, pre_poses, generator)
        else:
            out_poses = self.decoder(latent)
        return (context_feat, context_mu, context_logvar,
                poses_feat, pose_mu, pose_logvar, out_poses)


def build_embedding_net(cfg, n_words: int, mode: str, seed: int,
                        device: torch.device | str = "cuda") -> EmbeddingNet:
    """EmbeddingNet in `mode` for `cfg`'s poses on `cfg.hop`'s GRU route,
    initialised from `seed` on the host, moved to `device`."""
    d = cfg.data
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = EmbeddingNet(d.pose_dim, d.n_poses, n_words, mode, d.n_pre_poses,
                           gru_kernel=cfg.hop.gru_kernel,
                           gru_bf16_streams=cfg.hop.gru_bf16_streams)
    return net.to(device)
