"""SE-ResNet-34 multi-scale audio encoder of the hierarchical (HA2G) model
(port of hop_tpu/models/resnet_se.py; reference model/ResNetSE34V2.py:13-219,
model/ResNetBlocks.py:7-96).

SE basic blocks (3, 4, 6, 3) with filters (32, 64, 128, 256) over the
(mels = 128, T) spectrogram; the maps after layer2, layer3 and layer4 are
brought to a common (62/63 high, 34 wide) grid, the two deeper ones by
pixel shuffle (torch's `F.pixel_shuffle`, the reference's own op) and
valid convolutions, and each is projected to `n_out` features a time step
(fc_low / fc_mid / fc_high); a speaker-conditioned softmax over the three
levels blends them once per cascade stage (`pose_level`).

Layout NCHW (B, C, mels, T), the reference's. hop_tpu is feature-last and
flattens channel-major after a transpose (resnet_se.py:114, :122, :130);
here that flatten is a plain `reshape(B, C * H, W)`. `feat_low` is one frame
longer where T is odd in the taps; all three are cut to the common length
(resnet_se.py:136-139). BatchNorm follows flax's training rule, its batch
variance taken about the mean (`common.CenteredBatchNorm2d`: the same
statistics, without the cancellation of E[x^2] - E[x]^2 on the dB-scale
spectrogram); the speaker table is a `common.WordEmbedding`, whose
gradient sums in a fixed order. Children carry the reference's names
(`conv1`, `bn1`, `layer{k}.{i}.conv1/bn1/conv2/bn2/se.fc.{0,2}/downsample.
{0,1}`, `conv_low/bn_low/fc_low` and mid, high, `speaker_embedding.{0,1}`,
`fc1`, `fc2`), which hop_tpu's `convert_resnet_se` reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hop_tpu_torch.models import common


class SELayer(nn.Module):
    """Squeeze-excitation, reduction 8 (ResNetBlocks.py:82-96)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, channels),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv -> relu -> bn -> conv -> bn -> SE -> + residual -> relu
    (ResNetBlocks.py:7-37, the reference's conv1 -> relu -> bn1 order)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = common.CenteredBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = common.CenteredBatchNorm2d(planes)
        self.se = SELayer(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                common.CenteredBatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(torch.relu(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


def _half(n: int) -> int:
    """A stride-2, padding-1, kernel-3 convolution's output length."""
    return (n + 1) // 2


class ResNetSE(nn.Module):
    """(spectrogram (B, mels, T), speaker ids (B,) or None) -> (weight (B, 3,
    pose_level) or None, feat_low, feat_mid, feat_high (B, t, n_out), the
    per-level blends)."""

    def __init__(self, n_speakers: int, pose_level: int = 3, n_out: int = 32,
                 layers=(3, 4, 6, 3), filters=(32, 64, 128, 256), n_mels: int = 128):
        super().__init__()
        self.pose_level = pose_level
        self.conv1 = nn.Conv2d(1, filters[0], 3, padding=1)
        self.bn1 = common.CenteredBatchNorm2d(filters[0])
        width = filters[0]
        for k, (planes, blocks) in enumerate(zip(filters, layers), start=1):
            stride = 1 if k == 1 else 2
            first = SEBasicBlock(width, planes, stride,
                                 downsample=stride != 1 or width != planes)
            setattr(self, f"layer{k}", nn.Sequential(
                first, *(SEBasicBlock(planes, planes) for _ in range(1, blocks))))
            width = planes
        h2 = _half(n_mels)            # layer2's height; layer3's and 4's halve it
        h3, h4 = _half(h2), _half(_half(h2))
        self.conv_low = nn.Conv2d(filters[1], 64, 2)
        self.bn_low = common.CenteredBatchNorm2d(64)
        self.fc_low = nn.Linear(64 * (h2 - 1), n_out)
        self.conv_mid = nn.Conv2d(filters[2] // 4, 32, 3)
        self.bn_mid = common.CenteredBatchNorm2d(32)
        self.fc_mid = nn.Linear(32 * (2 * h3 - 2), n_out)
        self.conv_high = nn.Conv2d(filters[3] // 16, 16, 3)
        self.bn_high = common.CenteredBatchNorm2d(16)
        self.fc_high = nn.Linear(16 * (4 * h4 - 2), n_out)
        self.speaker_embedding = nn.Sequential(common.WordEmbedding(n_speakers, 16),
                                               nn.Linear(16, 16))
        self.fc1 = nn.Linear(16, 32)
        self.fc2 = nn.Linear(32, 3 * pose_level)

    @staticmethod
    def _tap(x: torch.Tensor, conv: nn.Module, bn: nn.Module, fc: nn.Module):
        """conv -> relu -> bn, the channel-major (C, H) flatten per time step,
        and the projection: (B, t, n_out)."""
        y = bn(torch.relu(conv(x)))
        B, C, H, W = y.shape
        return fc(y.reshape(B, C * H, W).transpose(1, 2))

    def forward(self, spectrogram: torch.Tensor,
                vid_indices: Optional[torch.Tensor] = None):
        x = self.bn1(torch.relu(self.conv1(spectrogram[:, None])))
        feat1 = self.layer2(self.layer1(x))
        feat2 = self.layer3(feat1)
        feat3 = self.layer4(feat2)
        feat_low = self._tap(feat1, self.conv_low, self.bn_low, self.fc_low)
        feat_mid = self._tap(F.pixel_shuffle(feat2, 2), self.conv_mid, self.bn_mid,
                             self.fc_mid)
        feat_high = self._tap(F.pixel_shuffle(feat3, 4), self.conv_high, self.bn_high,
                              self.fc_high)
        t = min(feat_low.shape[1], feat_mid.shape[1], feat_high.shape[1])
        feat_low, feat_mid, feat_high = feat_low[:, :t], feat_mid[:, :t], feat_high[:, :t]
        if vid_indices is None:
            return None, feat_low, feat_mid, feat_high, []
        h = F.elu(self.speaker_embedding(vid_indices))
        h = self.fc2(F.elu(self.fc1(h)))
        weight = torch.softmax(h.reshape(-1, 3, self.pose_level), dim=1)
        blends = [feat_low * weight[:, 0, i, None, None]
                  + feat_mid * weight[:, 1, i, None, None]
                  + feat_high * weight[:, 2, i, None, None]
                  for i in range(self.pose_level)]
        return weight, feat_low, feat_mid, feat_high, blends
