"""Shared model pieces (port of hop_tpu/models/common.py): the reference's
identity LeakyReLU slope, reparameterisation, the speaker latent, the
train step's Huber and KL losses, BatchNorm with flax's training rule, the
Conv1d + BatchNorm + LeakyReLU element and the raw-waveform encoder of the
baseline zoo."""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.parallel.collectives import global_mean_var


# The reference writes nn.LeakyReLU(True), which torch parses as
# negative_slope=1.0, i.e. the identity (HOP.py:172).
IDENTITY_SLOPE = 1.0


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A table of host numbers (index lists, statistics) as a tensor on
    `device`, made once per device and copied from pinned memory: a step
    that reads it never makes the host wait for the card."""
    return _constant(tuple(values), dtype, torch.device(device))


class RowDraws:
    """A rank's share of a split batch's draws, passed where a model takes
    its `generator`: each draw is made for the whole batch, `n_shards`
    times the rank's rows, from `generator` (advancing it as the
    one-process pass does), and the rank keeps its block of rows."""

    def __init__(self, generator: Optional[torch.Generator], n_shards: int,
                 shard: int):
        self.generator, self.n_shards, self.shard = generator, n_shards, shard

    def randn(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        rows = shape[0]
        full = torch.randn((rows * self.n_shards, *shape[1:]),
                           generator=self.generator, dtype=dtype, device=device)
        return full[self.shard * rows:(self.shard + 1) * rows]


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator | RowDraws] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mu + eps * exp(0.5 logvar). The noise is drawn at inference too
    (as in the JAX model): pass `eps` to fix it, else it is drawn from
    `generator` on mu's device."""
    std = torch.exp(0.5 * logvar)
    if isinstance(generator, RowDraws):
        eps = generator.randn(std.shape, std.dtype, std.device) if eps is None else eps
    elif eps is None:
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


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               centered: bool = False) -> torch.Tensor:
    """BatchNorm over channel axis 1 with flax's training rule (hop_tpu's
    models/common.py:35-45, gwnet.py:139-140).

    In training it normalises with the batch mean and the BIASED batch
    variance, computed as flax does (E[x^2] - E[x]^2, clipped at 0), and
    updates the running statistics with that same biased variance:
    running = (1 - momentum) * running + momentum * batch. torch's
    BatchNorm would update the running variance with the unbiased one.
    `centered` computes the same variance as E[(x - E[x])^2], which does not
    cancel where the mean is large against the spread (`CenteredBatchNorm2d`).
    In eval mode it reads the running statistics.

    On a rank of a parallel run whose batch is split (`bn.batch_group` set by
    `parallel.attach_batch_group`) the statistics are the global batch's:
    the sums of every rank's rows, all-reduced with autograd, so that every
    rank normalises and updates its running statistics as one process on
    the whole batch would (hop_tpu gets this from XLA). torch's
    SyncBatchNorm would update the running variance with the unbiased one."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    if bn.batch_group is not None:
        mean, var = global_mean_var(x, dims, bn.batch_group, centered)
    elif centered:
        mean = x.mean(dims)
        dev = x - mean.reshape(shape)
        var = (dev * dev).mean(dims)
    else:
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

    batch_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and buffers, `batch_norm`'s rule."""

    batch_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x)


class CenteredBatchNorm2d(nn.BatchNorm2d):
    """`BatchNorm2d` with the batch variance taken about the mean
    (`batch_norm(centered=True)`): the same statistics, for inputs whose
    mean dwarfs their spread. The hierarchy's ResNetSE reads a spectrogram in
    dB (mean near -45, spread near 5); E[x^2] - E[x]^2 in f32 there costs
    hop_tpu's f32 gradients 1e-2 of their f64 values, and this form 3e-6."""

    batch_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x, centered=True)


class _OrderedEmbeddingGrad(torch.autograd.Function):
    """F.embedding whose weight gradient sums each id's rows in the order of
    their positions, without atomics: the ids sorted (stably), the rows of
    each id reduced by `segment_reduce` (a loop over the segment) into its
    row of the gradient. The segments' offsets are those of every id of the
    table (`searchsorted`, empty for an id the batch lacks), a fixed size:
    nothing makes the host wait for the card."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.n_rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        offsets = torch.searchsorted(
            flat[order], torch.arange(ctx.n_rows + 1, device=flat.device))
        rows = grad.reshape(flat.numel(), -1)[order]
        # unsafe: no check of the offsets, whose `.item()` would wait for
        # the card; they are sorted and end at len(rows) by construction
        return None, torch.segment_reduce(rows, "sum", offsets=offsets, unsafe=True)


class WordEmbedding(nn.Embedding):
    """nn.Embedding (its parameter, its init) whose weight gradient repeats
    bit for bit on the card: torch's CUDA backward of a lookup with many
    repeated ids (a batch's words: 8704 lookups of a few thousand words)
    accumulates in a varying order, and a resumed training run would drift
    from the uninterrupted one."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return _OrderedEmbeddingGrad.apply(ids, self.weight)


def conv1d_bn_leaky(in_channels: int, out_channels: int, kernel: int,
                    stride: int = 1, padding: int = 0, slope: float = 0.2) -> list:
    """Conv1d + BatchNorm + LeakyReLU, as a list of modules to splice into an
    nn.Sequential, so that they keep the reference's flat indices (hop_tpu's
    Conv1dBNLeaky, models/common.py:48-66). (B, C, T) layout."""
    return [nn.Conv1d(in_channels, out_channels, kernel, stride=stride, padding=padding),
            BatchNorm1d(out_channels), nn.LeakyReLU(slope)]


class WavEncoder(nn.Module):
    """Raw waveform (B, 36267) -> (B, 34, 32) (hop_tpu models/common.py:68-89;
    reference model/HOP.py:50-69): Conv1d 1 -> 16 (kernel 15, stride 5,
    padding 1600), then three convolutions of stride 6 to 32, 64 and 32
    channels, with BatchNorm and LeakyReLU(0.3) between. The children carry
    the reference's names (`feat_extractor.{0,3,6,9}` convolutions,
    `feat_extractor.{1,4,7}` BatchNorm), which hop_tpu's
    `convert_wav_encoder` reads."""

    def __init__(self):
        super().__init__()
        self.feat_extractor = nn.Sequential(
            *conv1d_bn_leaky(1, 16, 15, stride=5, padding=1600, slope=0.3),
            *conv1d_bn_leaky(16, 32, 15, stride=6, slope=0.3),
            *conv1d_bn_leaky(32, 64, 15, stride=6, slope=0.3),
            nn.Conv1d(64, 32, 15, stride=6))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.feat_extractor(wav[:, None]).transpose(1, 2)
