"""Typed configuration for the port: the serving slice's presets.

A jax-free copy of `hop_tpu/config.py`'s DataConfig, LLMConfig, HOPConfig
and presets (`hop_tpu.config` imports `hop_tpu.geometry`, which imports
jax), holding the fields the port reads. Each has the JAX field's name
and value; tests/test_torch_config.py holds them field by field against
the JAX presets. The port builds the default HOP architecture only (BERT
backbone + reprogramming + gwnet): `hop_tpu`'s switches for the other
variants have no counterpart yet. The skeleton tables stay in
`hop_tpu.geometry`: the forward needs only the dir-vec width and the
gwnet node count, given here as constants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# dir-vec width = 3 * n_bones and gwnet graph nodes, per dataset
# (hop_tpu/geometry.py TED_SKELETON / EXPRESSIVE_SKELETON; HOP.py:136-139)
_POSE_DIM = {"TED": 27, "TED_expressive": 126}
_N_JOINTS_GRAPH = {"TED": 9, "TED_expressive": 42}


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "TED"                 # "TED" | "TED_expressive"
    n_poses: int = 34                    # frames per window
    n_pre_poses: int = 4                 # cross-fade frames between windows
    n_seed_frames: int = 16              # HOP seed frames
    pose_resampling_fps: int = 15
    sample_rate: int = 16000
    expected_audio_length: int = 36267   # 34 / 15 * 16000 rounded
    mel_bins: int = 128
    mel_n_fft: int = 1024
    mel_hop: int = 1096                  # => exactly 34 frames
    max_text_tokens: int = 2048
    use_hf_token_stream: bool = False

    @property
    def pose_dim(self) -> int:
        return _POSE_DIM[self.dataset]

    @property
    def n_joints_graph(self) -> int:
        """Graph nodes for gwnet: 9 (TED) / 42 (expressive)."""
        return _N_JOINTS_GRAPH[self.dataset]


@dataclass(frozen=True)
class LLMConfig:
    """Frozen language-model backbone. Only "BERT" is ported."""
    model: str = "BERT"                  # "BERT" | "LLAMA"
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    intermediate_dim: int = 3072
    vocab_size: int = 30522
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    compute_bf16: bool = True   # bf16 matmuls in the frozen backbone


@dataclass(frozen=True)
class HOPConfig:
    """HOP generator hyperparameters (reference model/HOP.py:72-174)."""
    d_model: int = 128                   # mel bins == reprogramming query dim
    n_heads: int = 8
    d_ff: int = 128                      # per-head key dim of reprogramming
    num_prototype_tokens: int = 1500
    hidden_size: int = 350               # BiGRU hidden
    gru_layers: int = 4
    z_size: int = 16
    beat_window: int = 3400
    beat_stride: int = 2191
    beat_feat: int = 170
    gwnet_residual: int = 64
    gwnet_dilation: int = 64
    gwnet_skip: int = 256
    gwnet_end: int = 512
    gwnet_blocks: int = 4
    gwnet_layers: int = 2
    gwnet_node_emb: int = 10
    gwnet_order: int = 2


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    hop: HOPConfig = field(default_factory=HOPConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def ted_config() -> Config:
    """TED Gesture preset."""
    return Config()


def expressive_config() -> Config:
    """TED Expressive preset."""
    return Config(data=DataConfig(dataset="TED_expressive"))


def tiny_test_config(dataset: str = "TED") -> Config:
    """Small shapes for unit tests / dry runs: real topology, thin layers."""
    base = ted_config() if dataset == "TED" else expressive_config()
    return base.replace(
        llm=LLMConfig(dim=64, n_layers=2, n_heads=4, intermediate_dim=128,
                      vocab_size=128, max_position=64),
        hop=dataclasses.replace(
            base.hop, d_model=128, n_heads=4, d_ff=16,
            num_prototype_tokens=32, hidden_size=64, gru_layers=2,
            gwnet_residual=16, gwnet_dilation=16, gwnet_skip=32,
            gwnet_end=32),
    )
