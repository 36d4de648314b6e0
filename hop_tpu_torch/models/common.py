"""Shared model pieces (port of hop_tpu/models/common.py): the reference's
identity LeakyReLU slope, reparameterisation, and the speaker latent."""

from __future__ import annotations

from typing import Optional

import torch
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
