"""The hierarchical (HA2G) generator stack: coarse-to-fine bone cascades
(port of hop_tpu/models/hierarchy.py; reference model/hierarchy_net.py:
55-242, the cascade routing of train_eval/train_hierarchy.py:100-170 and
train_hierarchy_expressive.py:140-213).

Each cascade stage generates a subset of the bones (`TED_STAGE_BONES`, 3
stages; `EXPRESSIVE_STAGE_BONES`, 6), seeded by the previous stage's output
on the bones the two share (`route_pre_seq`). A stage
(`HierarchicalPoseGenerator`) is the trimodal generator with its audio
features handed in (the shared `ResNetSE`'s blend for its level): seed ++
audio ++ TextEncoderTCN ++ speaker latent through a 4-layer BiGRU (kernel K2
or K3 on CUDA), its directions summed, Linear(hidden / 2), LeakyReLU(0.01),
Linear(pose_dim). `HierarchicalConvDiscriminator` is the ConvDiscriminator
with LeakyReLU(0.01) (the reference's default slope) in place of the
identity; `HierarchicalDiscriminator` (the text Discriminator without its
text) and `HierarchicalTextEncoder` are kept for checkpoint parity and for
the contrastive terms' text features.
Children carry the names of hop_tpu's `convert_hierarchical_generator` and
`convert_conv_discriminator`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from hop_tpu_torch.models import common
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator, Discriminator
from hop_tpu_torch.models.resnet_se import ResNetSE
from hop_tpu_torch.models.tcn import TextEncoderTCN
from hop_tpu_torch.ops.gru import GRU

# Bone subsets per cascade stage (global bone indices into the dir-vec
# tables of geometry.py), from the reference's target slices
# (train_hierarchy.py:86-88, train_hierarchy_expressive.py:140-145)
TED_STAGE_BONES = (
    (0, 1, 2, 3, 6),
    (0, 1, 2, 3, 4, 6, 7),
    tuple(range(9)),
)

EXPRESSIVE_STAGE_BONES = (
    (0, 1, 2, 37, 38, 39, 40, 41),
    (0, 1, 2, 3, 20, 37, 38, 39, 40, 41),
    (0, 1, 2, 3, 4, 20, 21, 37, 38, 39, 40, 41),
    (0, 1, 2, 3, 4, 5, 8, 11, 14, 17, 20, 21, 22, 25, 28, 31, 34,
     37, 38, 39, 40, 41),
    (0, 1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18, 20, 21, 22, 23,
     25, 26, 28, 29, 31, 32, 34, 35, 37, 38, 39, 40, 41),
    tuple(range(42)),
)

# the physical prior's statistics (train_hierarchy.py:15-16)
TED_AVG_ANGLE = (0.22037504613399506, 0.4590071439743042,
                 0.22463147342205048, 0.45562979578971863)
TED_VAR_ANGLE = (0.0018439559498801827, 0.013570506125688553,
                 0.0017794054001569748, 0.013684595935046673)


def stage_bones(dataset: str) -> tuple:
    return TED_STAGE_BONES if dataset == "TED" else EXPRESSIVE_STAGE_BONES


def routing_tail(dataset: str) -> int:
    """The trailing face-bone block routed by the reference's off-by-one
    `-5*3:` column write (Expressive only); see `route_pre_seq`."""
    return 0 if dataset == "TED" else 5


def bone_slice_indices(bones: Sequence[int]) -> np.ndarray:
    """The flattened dir-vec channels of a bone subset."""
    return np.concatenate([np.arange(b * 3, b * 3 + 3) for b in bones])


def _indices(values, device) -> torch.Tensor:
    return common.device_constant(np.asarray(values).tolist(), torch.long, device)


def slice_target(target: torch.Tensor, bones: Sequence[int]) -> torch.Tensor:
    return target.index_select(-1, _indices(bone_slice_indices(bones), target.device))


def route_pre_seq(target_k: torch.Tensor, prev_out: Optional[torch.Tensor],
                  bones_k: Sequence[int], bones_prev: Optional[Sequence[int]],
                  n_pre_poses: int, tail_bones: int = 0) -> torch.Tensor:
    """Stage k's seed (B, T, D + 1): the target's first n_pre_poses frames
    and an indicator bit, then frames >= n_pre_poses overwritten by the
    previous stage's output on the shared bones.

    `tail_bones` reproduces the reference's Expressive routing exactly
    (hop_tpu/models/hierarchy.py:72-108): each transition ends with
    `pre_seq_k[:, n_pre:, -5*3:] = out_prev[:, n_pre:, -5*3:]` on a seed of
    D + 1 channels, so the face-bone block lands one channel late: the first
    face-bone x keeps its zero and the indicator column takes the last face
    bone's z. The aligned writes come first and the tail overwrites them."""
    B, T, D = target_k.shape
    pre = target_k.new_zeros(B, T, D + 1)
    pre[:, :n_pre_poses, :D] = target_k[:, :n_pre_poses]
    pre[:, :n_pre_poses, D] = 1.0
    if prev_out is not None:
        pos_k = {b: i for i, b in enumerate(bones_k)}
        aligned = bones_prev[:-tail_bones] if tail_bones else bones_prev
        dst, src = [], []
        for j, b in enumerate(aligned):
            i = pos_k[b]
            dst.extend(range(i * 3, i * 3 + 3))
            src.extend(range(j * 3, j * 3 + 3))
        pre[:, n_pre_poses:, _indices(dst, pre.device)] = prev_out[:, n_pre_poses:].index_select(
            -1, _indices(src, pre.device))
        if tail_bones:
            w = tail_bones * 3
            pre[:, n_pre_poses:, D + 1 - w:] = prev_out[:, n_pre_poses:,
                                                        prev_out.shape[-1] - w:]
    return pre


class HierarchicalPoseGenerator(common.SpeakerLatent):
    """One cascade stage: (pre_seq (B, T, pose_dim + 1), word ids (B, T),
    audio features (B, T, 32), speaker ids (B,)) -> (poses (B, T, pose_dim),
    z, mu, logvar) (reference hierarchy_net.py:55-149)."""

    def __init__(self, pose_dim: int, n_words: int, n_speakers: int,
                 hidden_size: int = 300, n_layers: int = 4, dropout: float = 0.3,
                 z_size: int = 16, gru_kernel: str = "fused",
                 gru_bf16_streams: bool = False):
        super().__init__(n_speakers, z_size)
        self.hidden_size = hidden_size
        self.text_encoder = TextEncoderTCN(n_words, channels=(hidden_size,) * n_layers,
                                           dropout=dropout)
        self.gru = GRU(pose_dim + 1 + 32 + 32 + z_size, hidden_size, num_layers=n_layers,
                       bidirectional=True, dropout=dropout, kernel=gru_kernel,
                       bf16_streams=gru_bf16_streams)
        self.out = nn.Sequential(nn.Linear(hidden_size, hidden_size // 2),
                                 nn.LeakyReLU(0.01),
                                 nn.Linear(hidden_size // 2, pose_dim))

    def forward(self, pre_seq: torch.Tensor, in_text: torch.Tensor,
                audio_feat: torch.Tensor, vid_indices: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """`generator` draws the dropout masks (training mode) and, unless
        `eps` is given, the speaker noise."""
        z, mu, logvar = self.speaker(vid_indices, generator, eps)
        T = pre_seq.shape[1]
        x = torch.cat([pre_seq, audio_feat, self.text_encoder(in_text, generator),
                       z[:, None].expand(-1, T, -1)], dim=-1)
        out, _ = self.gru(x, generator)
        H = self.hidden_size
        return self.out(out[..., :H] + out[..., H:]), z, mu, logvar


class HierarchicalConvDiscriminator(ConvDiscriminator):
    """The ConvDiscriminator with LeakyReLU(0.01) between its convolutions
    (reference hierarchy_net.py:197-242)."""

    def __init__(self, pose_dim: int, n_poses: int = 34, gru_kernel: str = "fused",
                 gru_bf16_streams: bool = False):
        super().__init__(pose_dim, n_poses, gru_kernel, gru_bf16_streams)
        for i in (2, 5):
            self.pre_conv[i] = nn.LeakyReLU(0.01)


#: the GRU discriminator (reference hierarchy_net.py:153-194) is the trimodal
#: text-conditioned one without its text; kept for checkpoint parity
HierarchicalDiscriminator = Discriminator


class HierarchicalTextEncoder(TextEncoderTCN):
    """TextEncoderTCN at the stages' width (hierarchy_net.py:22-52): word ids
    (B, T) -> (B, T, 32)."""

    def __init__(self, n_words: int, hidden_size: int = 300, n_layers: int = 4,
                 dropout: float = 0.3):
        super().__init__(n_words, channels=(hidden_size,) * n_layers, dropout=dropout)


def build_hierarchy(cfg, n_words: int, n_speakers: int, seed: int,
                    device: torch.device | str = "cuda"):
    """The hierarchy's generator side as one module (`HierarchyNet`: the
    audio encoder, the text encoder and the stages, coarse to fine) and its
    discriminator, at `cfg.baseline`'s widths on `cfg.hop`'s GRU route,
    initialised from `seed` and `seed + 1` on the host and moved to
    `device`; the caller's global RNG state is left as it was."""
    h = cfg.hop
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = HierarchyNet(cfg, n_words, n_speakers)
        torch.manual_seed(seed + 1)
        disc = HierarchicalConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses,
                                             h.gru_kernel, h.gru_bf16_streams)
    return net.to(device), disc.to(device)


class HierarchyNet(nn.Module):
    """The generator side of the hierarchy: `audio` (ResNetSE with one blend
    per stage), `text` (the contrastive terms' HierarchicalTextEncoder) and
    `stages` (one HierarchicalPoseGenerator per bone subset), each the
    reference's module of its own (hierarchy_net.py), under one optimizer
    (hop_tpu/train/hierarchy.py:9-13)."""

    def __init__(self, cfg, n_words: int, n_speakers: int, resnet_layers=(3, 4, 6, 3)):
        super().__init__()
        b, h = cfg.baseline, cfg.hop
        self.bones = stage_bones(cfg.data.dataset)
        self.tail = routing_tail(cfg.data.dataset)
        self.n_pre_poses = cfg.data.n_pre_poses
        self.audio = ResNetSE(n_speakers, pose_level=len(self.bones),
                              layers=tuple(resnet_layers), n_mels=cfg.data.mel_bins)
        self.text = HierarchicalTextEncoder(n_words, b.hidden_size, b.n_layers,
                                            b.dropout_prob)
        self.stages = nn.ModuleList(
            HierarchicalPoseGenerator(len(bn) * 3, n_words, n_speakers, b.hidden_size,
                                      b.n_layers, b.dropout_prob, gru_kernel=h.gru_kernel,
                                      gru_bf16_streams=h.gru_bf16_streams)
            for bn in self.bones)

    def cascade(self, target: torch.Tensor, text: torch.Tensor, blends, vids: torch.Tensor,
                generator: Optional[torch.Generator] = None, eps=None):
        """Every stage, coarse to fine, each seeded from the target's first
        frames and the previous stage's output (`route_pre_seq`): (the
        stages' outputs, (z, mu, logvar) of the last). `eps` (n_stages, B,
        z), else each stage draws its speaker noise from `generator`."""
        outs, prev, latent = [], None, None
        for k, stage in enumerate(self.stages):
            pre = route_pre_seq(slice_target(target, self.bones[k]), prev, self.bones[k],
                                self.bones[k - 1] if k else None, self.n_pre_poses,
                                tail_bones=self.tail)
            prev, *latent = stage(pre, text, blends[k], vids, generator=generator,
                                  eps=None if eps is None else eps[k])
            outs.append(prev)
        return outs, latent

    def generate(self, batch: dict, vids: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The last stage's poses (B, T, pose_dim) for `batch`'s spectrogram,
        words and seed frames (hop_tpu train_main.py:242-261)."""
        blends = self.audio(batch["spectrogram"], vids)[4]
        return self.cascade(batch["target_vec"], batch["text_padded"], blends, vids,
                            generator)[0][-1]
