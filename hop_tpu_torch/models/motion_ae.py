"""Motion autoencoder: the TED-Expressive feature net of FGD (port of
hop_tpu/models/motion_ae.py; reference model/motion_ae.py:33-130, loaded
frozen by EmbeddingSpaceEvaluator.py:411-414).

A 34-frame convolutional encoder to `latent_dim` and a convolutional
decoder back to pose space, with the reference's torch names
(`encoder.net.*`, `encoder.out_net.*`, `decoder.pre_net.*`,
`decoder.net.*`), so `hop_tpu.eval.torch_import.convert_motion_ae` reads
this module's state_dict. Poses are feature-last, (B, 34, pose_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from hop_tpu_torch.models import common
from hop_tpu_torch.models.embedding_net import (ConvNormRelu, PoseDecoderConv,
                                                _leaky_identity)


class MotionPoseEncoder(nn.Module):
    def __init__(self, pose_dim: int, latent_dim: int):
        super().__init__()
        self.net = nn.Sequential(
            ConvNormRelu(pose_dim, 32), ConvNormRelu(32, 64),
            ConvNormRelu(64, 64, downsample=True), nn.Conv1d(64, 32, 3))
        self.out_net = nn.Sequential(
            nn.Linear(384, 256), common.BatchNorm1d(256), _leaky_identity(),
            nn.Linear(256, 128), common.BatchNorm1d(128), _leaky_identity(),
            nn.Linear(128, latent_dim))

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.net(poses.transpose(1, 2)).flatten(1))


class MotionPoseDecoder(PoseDecoderConv):
    """hop_tpu's MotionPoseDecoder: PoseDecoderConv from `latent_dim`."""

    def __init__(self, pose_dim: int, latent_dim: int):
        super().__init__(34, pose_dim, latent_dim)


class MotionAE(nn.Module):
    """pose (B, 34, pose_dim) -> (reconstruction, latent)."""

    def __init__(self, pose_dim: int, latent_dim: int = 128):
        super().__init__()
        self.encoder = MotionPoseEncoder(pose_dim, latent_dim)
        self.decoder = MotionPoseDecoder(pose_dim, latent_dim)

    def forward(self, pose: torch.Tensor):
        pose = pose.reshape(pose.shape[0], pose.shape[1], -1)
        z = self.encoder(pose)
        return self.decoder(z), z
