"""Seq2seq text-to-gesture baseline (port of hop_tpu/models/seq2seq.py;
reference model/seq2seq_net.py:14-254).

A bidirectional word GRU encoder (4 layers of 300, inter-layer dropout 0.3:
kernel K2 or K3 on CUDA; its two directions summed, padded words masked to
zero), then a decoder run one frame at a time: Bahdanau attention over the
encoder's outputs from the top decoder state, Linear(pose_dim + H -> H), a
batch normalisation, ReLU, a stack of GRU cells and Linear(H -> pose_dim).
hop_tpu's choices are kept:
  * the decoder starts from `enc_hidden[:n_layers]`, the first n_layers
    entries of the encoder's last states in torch's (layer, direction) order
    (seq2seq.py:121);
  * the input of frame t + 1 is the target frame t while t < n_pre_poses
    (teacher forcing of the seed frames), else the decoder's own output;
  * the decoder's normalisation uses each step's batch statistics, in
    training and in evaluation alike, with a learned scale and bias and no
    running statistics (hop_tpu's compiled scan;
    eval/torch_import_generator.py:206-209).
The output's first frame is the target's. Children carry the names that
hop_tpu's `convert_seq2seq` reads: `encoder.embedding`, `encoder.gru.*`,
`decoder.decoder.attn.{attn,v}`, `decoder.decoder.pre_linear.{0,1}`,
`decoder.decoder.gru.weight_ih_l{k}`, ..., `decoder.decoder.out`. The
decoder's 33 steps run eagerly, each a handful of small products.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.models.common import WordEmbedding
from hop_tpu_torch.ops.gru import GRU, GRUCell
from hop_tpu_torch.parallel.collectives import global_mean_var


class EncoderRNN(nn.Module):
    """Embedding (`common.WordEmbedding`: its gradient repeats bit for bit)
    -> bidirectional GRU, the directions summed and masked."""

    def __init__(self, n_words: int, embed_size: int, hidden_size: int,
                 n_layers: int, dropout: float, gru_kernel: str = "fused",
                 gru_bf16_streams: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.embedding = WordEmbedding(n_words, embed_size)
        self.gru = GRU(embed_size, hidden_size, num_layers=n_layers,
                       bidirectional=True, dropout=dropout, kernel=gru_kernel,
                       bf16_streams=gru_bf16_streams)

    def forward(self, tokens, mask, generator: Optional[torch.Generator] = None):
        out, hidden = self.gru(self.embedding(tokens), generator)
        H = self.hidden_size
        return (out[..., :H] + out[..., H:]) * mask[..., None], hidden


class Attn(nn.Module):
    """Bahdanau additive attention (reference seq2seq_net.py:59-89): scores
    v · tanh(W [h; e_t]) over the encoder steps, padded steps masked out."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.attn = nn.Linear(2 * hidden_size, hidden_size)
        self.v = nn.Parameter(torch.randn(hidden_size) / hidden_size ** 0.5)

    def forward(self, hidden, encoder_outputs, mask):
        T = encoder_outputs.shape[1]
        h = hidden[:, None].expand(-1, T, -1)
        energy = torch.tanh(self.attn(torch.cat([h, encoder_outputs], dim=-1)))
        scores = torch.where(mask > 0, energy @ self.v, -1e9)
        return torch.softmax(scores, dim=-1)


class BatchStatNorm(nn.Module):
    """Normalisation by the batch's own mean and biased variance, with a
    learned scale (`weight`) and bias: the decoder's BatchNorm1d as hop_tpu
    computes it, in every mode."""

    batch_group = None

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.batch_group is not None:     # the global batch's (common.batch_norm)
            mean, var = (s[None] for s in global_mean_var(x, [0], self.batch_group,
                                                          centered=True))
            return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        mean = x.mean(0, keepdim=True)
        var = ((x - mean) ** 2).mean(0, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class DecoderStep(nn.Module):
    """One decoder frame: attention, pre-linear, the GRU cells, out."""

    def __init__(self, hidden_size: int, output_size: int, n_layers: int):
        super().__init__()
        self.attn = Attn(hidden_size)
        self.pre_linear = nn.Sequential(nn.Linear(output_size + hidden_size, hidden_size),
                                        BatchStatNorm(hidden_size), nn.ReLU())
        self.gru = GRUCell(hidden_size, hidden_size, n_layers)
        self.out = nn.Linear(hidden_size, output_size)

    def forward(self, motion_input, hidden, encoder_outputs, mask):
        attn_w = self.attn(hidden[-1], encoder_outputs, mask)
        context = torch.einsum("bt,bth->bh", attn_w, encoder_outputs)
        hidden = self.gru(self.pre_linear(torch.cat([motion_input, context], dim=-1)),
                          hidden)
        return self.out(hidden[-1]), hidden


class Seq2SeqNet(nn.Module):
    """(word ids (B, W), word mask (B, W), target poses (B, T, pose_dim)) ->
    poses (B, T, pose_dim) (reference seq2seq_net.py:217-254)."""

    def __init__(self, pose_dim: int, n_frames: int, n_pre_poses: int, n_words: int,
                 embed_size: int = 300, hidden_size: int = 300, n_layers: int = 4,
                 dropout: float = 0.3, gru_kernel: str = "fused",
                 gru_bf16_streams: bool = False):
        super().__init__()
        self.n_frames, self.n_pre_poses, self.n_layers = n_frames, n_pre_poses, n_layers
        self.encoder = EncoderRNN(n_words, embed_size, hidden_size, n_layers, dropout,
                                  gru_kernel, gru_bf16_streams)
        self.decoder = nn.Module()
        self.decoder.decoder = DecoderStep(hidden_size, pose_dim, n_layers)

    def forward(self, in_text, text_mask, poses,
                generator: Optional[torch.Generator] = None):
        """`generator` draws the encoder's dropout masks (training mode)."""
        enc_out, enc_hidden = self.encoder(in_text, text_mask, generator)
        hidden = enc_hidden[:self.n_layers]
        step = self.decoder.decoder
        prev, outs = poses[:, 0], [poses[:, :1]]
        for t in range(1, self.n_frames):
            out, hidden = step(prev, hidden, enc_out, text_mask)
            outs.append(out[:, None])
            prev = poses[:, t] if t < self.n_pre_poses else out
        return torch.cat(outs, dim=1)


def build_seq2seq(cfg, n_words: int, seed: int,
                  device: torch.device | str = "cuda") -> Seq2SeqNet:
    """Seq2SeqNet at `cfg.baseline`'s widths on `cfg.hop`'s GRU route,
    initialised from `seed` on the host, moved to `device`."""
    b, d = cfg.baseline, cfg.data
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = Seq2SeqNet(d.pose_dim, d.n_poses, d.n_pre_poses, n_words,
                         d.wordembed_dim, b.hidden_size, b.n_layers, b.dropout_prob,
                         cfg.hop.gru_kernel, cfg.hop.gru_bf16_streams)
    return net.to(device)
