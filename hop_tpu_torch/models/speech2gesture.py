"""Speech2Gesture baseline: a 2D CNN over the spectrogram and a 1D U-Net
generator, with a convolutional discriminator (port of
hop_tpu/models/speech2gesture.py; reference model/speech2gesture.py:106-251).

Convolutions only, no kernel of the port's own. TF's SAME padding (flax's
padding="SAME": ceil(L / s) outputs, the padding split low = total // 2) is
an explicit `F.pad` in front of the convolution, since torch's "same" takes
no stride. The resize to (n_frames, 1) is bilinear with half-pixel centres
and no antialiasing (torch's `interpolate(align_corners=False)`, hop_tpu's
`jax.image.resize(antialias=False)`), computed as two products with the
interpolation weights (`linear_resize_weights`): torch's CUDA backward of
`interpolate` adds into the few output rows with atomics, in a varying
order and slowly. BatchNorm follows flax's training
rule (`common.batch_norm`). Children carry the names hop_tpu's
`convert_s2g_generator` and `convert_s2g_discriminator` read
(`audio_encoder.first_net.{i}`, `audio_encoder.down{1..6}`,
`audio_encoder.up{1..5}.conv`, `pre_pose_encoder.*`, `decoder.{i}`,
`final_out`; the discriminator's `net.{0,2,3,4}`), each ConvNormRelu a
Sequential (convolution, BatchNorm, LeakyReLU(0.2)). Layout (B, C, T) and
(B, C, H, W) inside; poses enter and leave as (B, T, pose_dim).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.models import common


def _same_pads(length: int, kernel: int, stride: int):
    total = max((-(-length // stride) - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """Conv1d with TF's SAME padding (any stride)."""

    def forward(self, x):
        lo, hi = _same_pads(x.shape[-1], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, (lo, hi)))


class SameConv2d(nn.Conv2d):
    """Conv2d with TF's SAME padding (any stride)."""

    def forward(self, x):
        h = _same_pads(x.shape[-2], self.kernel_size[0], self.stride[0])
        w = _same_pads(x.shape[-1], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (*w, *h)))


def conv_norm_relu(in_channels: int, out_channels: int, conv_type: str = "1d",
                   downsample: bool = False, k=None, s=None,
                   padding: str = "SAME") -> nn.Sequential:
    """Convolution (kernel 4 stride 2 when downsampling, else 3 and 1),
    BatchNorm, LeakyReLU(0.2) (reference speech2gesture.py:106-141)."""
    k = k if k is not None else (4 if downsample else 3)
    s = s if s is not None else (2 if downsample else 1)
    two_d = conv_type == "2d"
    if padding == "SAME":
        conv = (SameConv2d if two_d else SameConv1d)(in_channels, out_channels, k, s)
    else:
        conv = (nn.Conv2d if two_d else nn.Conv1d)(in_channels, out_channels, k, s)
    norm = (common.BatchNorm2d if two_d else common.BatchNorm1d)(out_channels)
    return nn.Sequential(conv, norm, nn.LeakyReLU(0.2))


def linear_resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) weights of a linear resize with half-pixel centres: the
    source position (i + 0.5) * n_in / n_out - 0.5, clamped at 0, between
    its two neighbours, the upper one clamped at n_in - 1 (torch's
    interpolate with align_corners=False, in its f32 arithmetic). Made on
    `device` from no host data, so nothing waits for the card."""
    scale = torch.full((), n_in / n_out, dtype=torch.float32, device=device)
    src = (scale * (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
           - 0.5).clamp(min=0.0)
    lo = src.floor().long().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = (src - lo)[:, None]
    cols = torch.arange(n_in, device=device)
    # (1 - frac) + frac where both neighbours are the last column
    return (1.0 - frac) * (cols == lo[:, None]) + frac * (cols == hi[:, None])


class UnetUp(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv_norm_relu(channels, channels)

    def forward(self, x1, x2):
        """Repeat x1 twice along time, crop to the skip's length, add, conv."""
        x1 = x1.repeat_interleave(2, dim=2)[..., :x2.shape[2]]
        return self.conv(x1 + x2)


class AudioEncoder(nn.Module):
    """(B, mels, T) spectrogram -> (B, 256, n_frames) (reference
    speech2gesture.py:144-197)."""

    def __init__(self, n_frames: int):
        super().__init__()
        self.n_frames = n_frames
        self.first_net = nn.Sequential(
            conv_norm_relu(1, 64, "2d"),
            conv_norm_relu(64, 64, "2d", downsample=True),
            conv_norm_relu(64, 128, "2d"),
            conv_norm_relu(128, 128, "2d", downsample=True),
            conv_norm_relu(128, 256, "2d"),
            conv_norm_relu(256, 256, "2d", downsample=True),
            conv_norm_relu(256, 256, "2d"),
            conv_norm_relu(256, 256, "2d", padding="VALID"))
        self.down1 = nn.Sequential(conv_norm_relu(256, 256), conv_norm_relu(256, 256))
        for i in range(2, 7):
            setattr(self, f"down{i}", conv_norm_relu(256, 256, downsample=True))
        for i in range(1, 6):
            setattr(self, f"up{i}", UnetUp(256))

    def forward(self, spectrogram):
        x = self.first_net(spectrogram[:, None])            # (B, 256, H', W')
        rows = linear_resize_weights(x.shape[2], self.n_frames, x.device).to(x.dtype)
        cols = linear_resize_weights(x.shape[3], 1, x.device)[0].to(x.dtype)
        x = torch.einsum("oh,bchw,w->bco", rows, x, cols)   # (B, 256, n_frames)
        skips = [self.down1(x)]                             # x2
        for i in range(2, 7):
            skips.append(getattr(self, f"down{i}")(skips[-1]))   # x3 .. x7
        x = skips.pop()
        for i in range(1, 6):
            x = getattr(self, f"up{i}")(x, skips.pop())
        return x


class Generator(nn.Module):
    """(spectrogram (B, mels, T), seed poses (B, n_pre, pose_dim)) -> poses
    (B, n_poses, pose_dim) (reference speech2gesture.py:200-231)."""

    def __init__(self, n_poses: int, pose_dim: int, n_pre_poses: int):
        super().__init__()
        self.audio_encoder = AudioEncoder(n_poses)
        self.pre_pose_encoder = nn.Sequential(
            nn.Linear(n_pre_poses * pose_dim, 32), common.BatchNorm1d(32), nn.ReLU(),
            nn.Linear(32, 16))
        self.decoder = nn.Sequential(conv_norm_relu(256 + 16, 256),
                                     *(conv_norm_relu(256, 256) for _ in range(3)))
        self.final_out = nn.Conv1d(256, pose_dim, 1)

    def forward(self, in_spec, pre_poses):
        audio = self.audio_encoder(in_spec)                       # (B, 256, T)
        pp = self.pre_pose_encoder(pre_poses.flatten(1))
        pp = pp[:, :, None].expand(-1, -1, audio.shape[2])
        x = self.decoder(torch.cat([audio, pp], dim=1))
        return self.final_out(x).transpose(1, 2)


class Discriminator(nn.Module):
    """Pose sequence -> per-patch scores (B, L, 1) over its first
    differences (reference speech2gesture.py:234-250)."""

    def __init__(self, pose_dim: int):
        super().__init__()
        self.net = nn.Sequential(
            SameConv1d(pose_dim, 64, 4, 2), nn.LeakyReLU(0.2),
            conv_norm_relu(64, 128, downsample=True),
            conv_norm_relu(128, 256, k=4, s=1),
            SameConv1d(256, 1, 4))

    def forward(self, poses):
        x = (poses[:, 1:] - poses[:, :-1]).transpose(1, 2)
        return self.net(x).transpose(1, 2)


def build_s2g(cfg, seed: int, device: torch.device | str = "cuda"):
    """(Generator from `seed`, Discriminator from `seed + 1`), torch's default
    initialisation drawn on the host, moved to `device`."""
    d = cfg.data
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = Generator(d.n_poses, d.pose_dim, d.n_pre_poses)
        torch.manual_seed(seed + 1)
        disc = Discriminator(d.pose_dim)
    return gen.to(device), disc.to(device)
