"""Shared model pieces (port of hop_tpu/models/common.py): the reference's
identity LeakyReLU slope, reparameterisation, the speaker latent, the
train step's Huber and KL losses, and BatchNorm with flax's training rule."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# The reference writes nn.LeakyReLU(True), which torch parses as
# negative_slope=1.0, i.e. the identity (HOP.py:172).
IDENTITY_SLOPE = 1.0


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mu + eps * exp(0.5 logvar). The noise is drawn at inference too
    (as in the JAX model): pass `eps` to fix it, else it is drawn from
    `generator` on mu's device."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(std.shape, generator=generator, dtype=std.dtype,
                          device=std.device)
    return mu + eps.to(std) * std


class SpeakerLatent(nn.Module):
    """Speaker CVAE head: Embedding -> Linear -> (mu, logvar) -> z.

    The children carry the reference's names (`speaker_embedding.0/1`,
    `speaker_mu`, `speaker_logvar`); HOPModel inherits from this class so
    they sit at the top of its state_dict as in the reference."""

    def __init__(self, n_speakers: int, z_size: int = 16):
        super().__init__()
        self.speaker_embedding = nn.Sequential(nn.Embedding(n_speakers, z_size),
                                               nn.Linear(z_size, z_size))
        self.speaker_mu = nn.Linear(z_size, z_size)
        self.speaker_logvar = nn.Linear(z_size, z_size)

    def speaker(self, vid_indices: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        ctx = self.speaker_embedding(vid_indices)
        mu = self.speaker_mu(ctx)
        logvar = self.speaker_logvar(ctx)
        return reparameterize(mu, logvar, generator, eps), mu, logvar


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean(1 + logvar - mu^2 - exp(logvar)) (train_llm.py:73)."""
    return -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))


def huber(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.1,
          reduce: bool = True) -> torch.Tensor:
    """smooth_l1(pred/beta, target/beta) * beta (train_llm.py:46): a Huber
    loss with its transition at `beta`."""
    d = torch.abs(pred - target) / beta
    out = torch.where(d < 1.0, 0.5 * d * d, d - 0.5) * beta
    return out.mean() if reduce else out


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over channel axis 1 with flax's training rule (hop_tpu's
    models/common.py:35-45, gwnet.py:139-140).

    In training it normalises with the batch mean and the BIASED batch
    variance, computed as flax does (E[x^2] - E[x]^2, clipped at 0), and
    updates the running statistics with that same biased variance:
    running = (1 - momentum) * running + momentum * batch. torch's
    BatchNorm would update the running variance with the unbiased one.
    In eval mode it reads the running statistics."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1.0 - m) * bn.running_var + m * var)
        bn.num_batches_tracked += 1
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + bn.eps)
    return y * bn.weight.reshape(shape) + bn.bias.reshape(shape)


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d's parameters and buffers, `batch_norm`'s rule."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and buffers, `batch_norm`'s rule."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x)
