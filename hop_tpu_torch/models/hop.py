"""HOP generator: frozen LLM backbone (BERT, or LLaMA with
`cfg.llm.model="LLAMA"`) + reprogramming + graph wavenet + BiGRU head (port
of hop_tpu/models/hop.py; reference model/HOP.py:72-252).

Inputs for the TED config:
  in_audio (B, 36267) raw waveform
  x_enc    (B, 34, 128) per-sample log-mel (hop 1096)
  text     (B, 34) frame-aligned token ids
  pre_seq  (B, 16, pose_dim) seed dir-vec frames
  vid      (B,) speaker indices
Output: (B, 34, pose_dim) dir-vecs plus the speaker latent (z, mu, logvar).

The module is built in eval mode, for serving (gwnet's BatchNorm reads its
running statistics, no dropout); `.train()` switches on what the JAX
model's `train=True` does: gwnet's BatchNorm on batch statistics
(flax's rule, `common.batch_norm`) and the reprogramming attention's
dropout. Dropout in the frozen BERT (LLaMA has none) is gated separately, by `llm_train`
(default: follows the train mode), as in the JAX trunk
(hop_tpu/models/hop.py:137-152). The backbone's weights do not require
grad; gradients still flow through it into `align_layer` and what feeds
it. The speaker latent draws noise (as in the JAX model) from `generator`
or a given `eps`. Kernels on this path: K1 in the reprogramming layer,
once per GRU layer K2 or, with `cfg.hop.gru_kernel="stack"`, K3, and once
per backbone layer K4 or K5 with `cfg.llm.attention="fused"` or `"block"`
(BERT only). The head's first GRU layer is `gru_input_size` wide: 992 on
BERT at TED, 1751 at TED Expressive, 4320 on LLaMA-7B's 4096-wide backbone.

HOP's two ablations (`cfg.hop`, hop_tpu/models/hop.py:52-60, :154-190):
`use_reprogramming=False` builds no PrototypeMapper, ReprogrammingLayer or
align_layer and feeds the text embeddings straight to the backbone (K1 is
not launched); `use_gwnet=False` builds no beat MLP and gwnet, and the head
reads the seed poses with their indicator bit and the `WavEncoder`'s audio
features (`audio_encoder.*`) in their place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hop_tpu_torch.config import Config
from hop_tpu_torch.models import common
from hop_tpu_torch.models.llama import make_llm_encoder
from hop_tpu_torch.models.gwnet import GraphWaveNet, receptive_field
from hop_tpu_torch.models.reprogramming import PrototypeMapper, ReprogrammingLayer
from hop_tpu_torch.ops.gru import GRU


def gru_input_size(cfg: Config) -> int:
    """Width of the head's input: seed graph + flag, beat features (without
    gwnet: seed poses + flag and the WavEncoder's features), LLM output and
    speaker latent (992 for TED on BERT, 1751 for TED Expressive, 4320 on
    LLaMA-7B)."""
    hop, d = cfg.hop, cfg.data
    if not hop.use_gwnet:       # seed poses + flag, WavEncoder's 32 features
        return d.pose_dim + 1 + 32 + cfg.llm.dim + hop.z_size
    N = d.n_joints_graph
    n_win = (d.expected_audio_length - hop.beat_window) // hop.beat_stride + 1
    rf = receptive_field(hop.gwnet_blocks, hop.gwnet_layers)
    t_out = max(n_win, rf) - rf + 1
    beat = hop.beat_feat * N * t_out // d.n_poses
    return 3 * N + 1 + beat + cfg.llm.dim + hop.z_size


class HOPModel(common.SpeakerLatent):
    """Children carry the reference's state_dict names (llm_model.*,
    speaker_embedding.*, mapping_layer, reprogramming_layer.*, align_layer,
    beat.0/2, gwnet.*, audio_encoder.* without gwnet, gru.*, out.0/3)."""

    def __init__(self, cfg: Config, n_speakers: int):
        hop = cfg.hop
        super().__init__(n_speakers, hop.z_size)
        self.cfg = cfg
        self.llm_model = make_llm_encoder(cfg.llm)
        self.llm_model.requires_grad_(False)     # frozen (HOP.py:90-91)
        if hop.use_reprogramming:
            self.mapping_layer = PrototypeMapper(cfg.llm.vocab_size,
                                                 hop.num_prototype_tokens)
            self.reprogramming_layer = ReprogrammingLayer(
                hop.d_model, hop.n_heads, hop.d_ff, cfg.llm.dim)
            self.align_layer = nn.Linear(2 * cfg.llm.dim, cfg.llm.dim)
        if hop.use_gwnet:
            self.beat = nn.Sequential(
                nn.Linear(hop.beat_window, hop.beat_window // 2),
                nn.LeakyReLU(0.2),
                nn.Linear(hop.beat_window // 2, hop.beat_feat))
            self.gwnet = GraphWaveNet(
                num_nodes=cfg.data.n_joints_graph,
                in_dim=3 + hop.beat_feat, out_dim=3 + hop.beat_feat,
                residual_channels=hop.gwnet_residual,
                dilation_channels=hop.gwnet_dilation,
                skip_channels=hop.gwnet_skip, end_channels=hop.gwnet_end,
                blocks=hop.gwnet_blocks, layers=hop.gwnet_layers,
                node_emb_dim=hop.gwnet_node_emb, gcn_order=hop.gwnet_order)
        else:
            self.audio_encoder = common.WavEncoder()
        self.gru = GRU(gru_input_size(cfg), hop.hidden_size, hop.gru_layers,
                       bidirectional=True, kernel=hop.gru_kernel,
                       bf16_streams=hop.gru_bf16_streams)
        self.out = nn.Sequential(
            nn.Linear(hop.hidden_size, hop.hidden_size // 2),
            nn.Dropout(0.0),
            nn.LeakyReLU(common.IDENTITY_SLOPE),
            nn.Linear(hop.hidden_size // 2, cfg.data.pose_dim))
        self.eval()    # built for serving; the train step calls .train()

    def _beat_features(self, in_audio: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, 16, N, beat_feat). The reference repeats the
        16 windows over the N joints and reinterprets memory with a view
        (HOP.py:210-212); the effect, beat_in[b, t, n] =
        feat[b, (t*N + n) % 16], is applied as the same static gather as
        the JAX model (hop.py:81-94)."""
        hop = self.cfg.hop
        N = self.cfg.data.n_joints_graph
        windows = in_audio.unfold(1, hop.beat_window, hop.beat_stride)
        feat = self.beat(windows)                           # (B, 16, 170)
        n_win = feat.shape[1]
        flat = torch.arange(n_win * N, device=feat.device) % n_win
        return feat[:, flat].reshape(feat.shape[0], n_win, N, -1)

    def forward(self, in_audio: torch.Tensor, x_enc: torch.Tensor,
                text: torch.Tensor, pre_seq: torch.Tensor,
                vid_indices: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                reprog_seed: int = 0, attn_seed: int = 0,
                llm_train: Optional[bool] = None):
        """`reprog_seed`, `attn_seed` and `llm_train` as in `trunk` (they
        matter in training mode only)."""
        z, mu, logvar = self.speaker(vid_indices, generator, eps)
        out = self.head(self.trunk(in_audio, x_enc, text, pre_seq,
                                   generator=generator, reprog_seed=reprog_seed,
                                   attn_seed=attn_seed, llm_train=llm_train), z)
        return out, z, mu, logvar

    def two_speaker_forward(self, in_audio, x_enc, text, pre_seq,
                            vid_indices, rand_vid_indices, *,
                            eps: torch.Tensor, eps_rand: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            reprog_seed: int = 0, attn_seed: int = 0,
                            llm_train: Optional[bool] = None):
        """The fused train step's forward (JAX hop.py:107-131): the
        speaker-independent trunk runs once; the head runs for the batch's
        speakers and, on the detached trunk and without a graph, for the
        shuffled ones (their output feeds only detached terms of the
        diversity regulariser), through K2's lean forward. Returns
        (out, out_rand, (z, mu, logvar), z_rand)."""
        z_a, mu_a, logvar_a = self.speaker(vid_indices, eps=eps)
        z_b, _, _ = self.speaker(rand_vid_indices, eps=eps_rand)
        trunk = self.trunk(in_audio, x_enc, text, pre_seq, generator=generator,
                           reprog_seed=reprog_seed, attn_seed=attn_seed,
                           llm_train=llm_train)
        out_a = self.head(trunk, z_a)
        with torch.no_grad():
            out_b = self.head(trunk.detach(), z_b.detach())
        return out_a, out_b, (z_a, mu_a, logvar_a), z_b

    def trunk(self, in_audio: torch.Tensor, x_enc: torch.Tensor,
              text: torch.Tensor, pre_seq: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              reprog_seed: int = 0, attn_seed: int = 0,
              llm_train: Optional[bool] = None) -> torch.Tensor:
        """`generator` draws the backbone's dropout masks, `reprog_seed`
        seeds K1's and `attn_seed` K4's or K5's (the backbone's kernel
        attention routes); `llm_train` gates the backbone's dropout
        (default: the train mode)."""
        cfg = self.cfg
        n_poses = cfg.data.n_poses
        N = cfg.data.n_joints_graph
        B = in_audio.shape[0]

        text_embeddings = self.llm_model.embed_tokens(text.long())
        llm_in = text_embeddings
        if cfg.hop.use_reprogramming:
            source = self.mapping_layer(self.llm_model.word_embeddings)
            enc_out = self.reprogramming_layer(x_enc, source, source,
                                               seed=reprog_seed)
            llm_in = self.align_layer(torch.cat([enc_out, text_embeddings], dim=-1))
        llm_det = not (self.training if llm_train is None else llm_train)
        dec_out = self.llm_model(llm_in, deterministic=llm_det, generator=generator,
                                 attn_seed=attn_seed)

        if not cfg.hop.use_gwnet:
            n_seed = pre_seq.shape[1]
            ges = pre_seq.new_zeros(B, n_poses, pre_seq.shape[2] + 1)
            ges[:, :n_seed, :-1] = pre_seq
            ges[:, :n_seed, -1] = 1.0
            return torch.cat([ges, self.audio_encoder(in_audio), dec_out], dim=-1)

        beat_in = self._beat_features(in_audio)
        seed = pre_seq.reshape(B, pre_seq.shape[1], N, 3)
        gw_in = torch.cat([seed, beat_in], dim=-1)            # (B, 16, N, 173)
        # the reference's (B, C, N, T) layout; its raw reshapes of the
        # gwnet output (HOP.py:221-229) then read memory in the same order
        feature = self.gwnet(gw_in.permute(0, 3, 2, 1))       # (B, 173, N, T)
        g_seq = feature[:, :3].reshape(B, 3 * N, -1).transpose(1, 2)
        beat = feature[:, 3:].reshape(B, n_poses, -1)         # (B, 34, 180)
        t_out = g_seq.shape[1]
        pre_padded = torch.zeros((B, n_poses, 3 * N + 1), device=in_audio.device)
        pre_padded[:, :t_out, :-1] = g_seq
        pre_padded[:, :t_out, -1] = 1.0
        return torch.cat([pre_padded, beat, dec_out], dim=-1)

    def head(self, trunk: torch.Tensor,
             z_context: Optional[torch.Tensor]) -> torch.Tensor:
        """Speaker latent concat + BiGRU + output MLP (HOP.py:241-251)."""
        dec_out = trunk
        if z_context is not None:
            rep = z_context[:, None, :].expand(-1, trunk.shape[1], -1)
            dec_out = torch.cat([dec_out, rep], dim=-1)
        out, _ = self.gru(dec_out.float())
        h = self.cfg.hop.hidden_size
        return self.out(out[..., :h] + out[..., h:])


def build_hop_model(cfg: Config, n_speakers: int, seed: int,
                    device: torch.device | str = "cuda", mesh=None) -> HOPModel:
    """HOPModel with torch's default initialisation drawn from `seed` (on the
    host, so the weights do not depend on the device), moved to `device`.
    The global RNG state of the caller is left as it was. On a rank of a
    `mesh` with a model axis the frozen backbone keeps this rank's share
    (`shard_`, tensor parallelism over the model group), cut on the host
    before the move: the device never holds the whole backbone."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = HOPModel(cfg, n_speakers)
    if mesh is not None and mesh.n_model > 1:
        model.llm_model.shard_(mesh.model_group, mesh.model_rank, mesh.n_model)
    return model.to(device)
