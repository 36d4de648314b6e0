"""The discriminator of the HOP GAN (port of ConvDiscriminator,
hop_tpu/models/multimodal_context.py:106-130; reference
model/multimodal_context_net.py:219-268).

Conv1d pose_dim -> 16 -> 8 -> 8 (kernel 3, valid: T 34 -> 28) with
BatchNorm and the reference's identity LeakyReLU between, a 4-layer
BiGRU(64) with inter-layer dropout 0.3 (kernel K2 or K3 on CUDA), a per-step
Linear(64, 1) and a Linear(28, 1) over time, then a sigmoid. Children
carry the reference's names (`pre_conv.{0,1,3,4,6}`, `gru.*`, `out`,
`out2`), which `hop_tpu.eval.torch_import_generator.
convert_conv_discriminator` reads. BatchNorm follows flax's training rule
(`common.batch_norm`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.models import common
from hop_tpu_torch.ops.gru import GRU

HIDDEN = 64


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
