"""Gesture autoencoder, pose mode: the TED feature net of FGD (port of
hop_tpu/models/embedding_net.py's ConvNormRelu, PoseEncoderConv,
PoseDecoderConv and EmbeddingNet(mode="pose"); reference
model/embedding_net.py:16-316, loaded frozen by
EmbeddingSpaceEvaluator.py:407-410).

Modules carry the reference's torch names (`pose_encoder.net.{i}.0/1`,
`pose_encoder.out_net.*`, `fc_mu`, `fc_logvar`, `decoder.pre_net.*`,
`decoder.net.*`), so `hop_tpu.eval.torch_import.convert_embedding_net_pose`
reads this module's state_dict as it reads the reference checkpoint.
Poses enter and leave feature-last, (B, T, pose_dim), as in hop_tpu; the
convolutions run in torch's (B, C, T) layout. BatchNorm is the port's
(`models.common.BatchNorm1d`), in eval mode for the frozen net. The other
modes (ContextEncoder, PoseDecoderGRU, PoseDecoderFC) come with the
joint-embedding baseline.
"""

from __future__ import annotations

import torch
from torch import nn

from hop_tpu_torch.models import common


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
    embedding_net.py:42-84). The latent is mu: the variational draw is the
    joint-embedding baseline's."""

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


class EmbeddingNet(nn.Module):
    """reference embedding_net.EmbeddingNet (:264-316), mode "pose":
    PoseEncoderConv + PoseDecoderConv, the FGD feature net."""

    def __init__(self, pose_dim: int, n_frames: int, n_words: int,
                 mode: str = "pose"):
        super().__init__()
        if mode != "pose":
            raise NotImplementedError(
                f"EmbeddingNet mode {mode!r}: only 'pose' (the FGD feature net) "
                f"is ported")
        self.mode = mode
        self.pose_encoder = PoseEncoderConv(pose_dim)
        self.decoder = PoseDecoderConv(n_frames, pose_dim)

    def forward(self, in_text, in_audio, pre_poses, poses):
        """hop_tpu's 7-tuple: (context_feat, context_mu, context_logvar,
        poses_feat, pose_mu, pose_logvar, out_poses); the context entries
        are None in pose mode (in_text, in_audio and pre_poses are unused)."""
        poses_feat, pose_mu, pose_logvar = self.pose_encoder(poses)
        out_poses = self.decoder(poses_feat)
        return None, None, None, poses_feat, pose_mu, pose_logvar, out_poses
