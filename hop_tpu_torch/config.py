"""Typed configuration for the port: the presets of the serving forward,
the train steps, the training run, the validation pass, the baseline
zoo and the hierarchy.

A jax-free copy of `hop_tpu/config.py`'s DataConfig, LLMConfig,
HOPConfig, BaselineConfig, LossConfig, TrainConfig and presets
(`hop_tpu.config` imports `hop_tpu.geometry`, which imports jax), holding
the fields the port reads. Each has the JAX field's name and value; tests/test_torch_config.py
holds them field by field against the JAX presets. `HOPConfig.gru_kernel`,
`gru_bf16_streams` and `LLMConfig.attention` are the port's own: the JAX
package reads those choices from environment variables. `HOPConfig.use_gwnet`
and `use_reprogramming` are HOP's two ablations (hop_tpu/config.py:104-105).
The dir-vec width and the gwnet node
count come from the port's skeletons (`hop_tpu_torch.geometry`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from hop_tpu_torch import geometry


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "TED"                 # "TED" | "TED_expressive"
    n_poses: int = 34                    # frames per window
    n_pre_poses: int = 4                 # cross-fade frames between windows
    n_seed_frames: int = 16              # HOP seed frames
    pose_resampling_fps: int = 15
    subdivision_stride: int = 10         # preprocessor window stride
    sample_rate: int = 16000
    expected_audio_length: int = 36267   # 34 / 15 * 16000 rounded
    mel_bins: int = 128
    mel_n_fft: int = 1024
    mel_hop: int = 1096                  # => exactly 34 frames
    wordembed_dim: int = 300
    max_text_tokens: int = 2048
    remove_word_timing: bool = True      # evenly spaced words (run_ted.py)
    use_hf_token_stream: bool = False
    # the reference's DataPreprocessor ingests only the first 50% of videos
    # (data_preprocessor.py:56-57): 0.5 reproduces it (data.import_ted)
    truncate_videos_frac: float = 1.0
    # wire dtype of the raw-audio transfer to the device (cli.common):
    # "int16" quantizes on the host to the PCM grid and dequantizes there
    audio_wire: str = "f32"              # "f32" | "int16"

    @property
    def pose_dim(self) -> int:
        return self.skeleton.pose_dim

    @property
    def skeleton(self) -> geometry.Skeleton:
        return (geometry.TED_SKELETON if self.dataset == "TED"
                else geometry.EXPRESSIVE_SKELETON)

    @property
    def n_joints_graph(self) -> int:
        """Graph nodes for gwnet: 9 (TED) / 42 (expressive): one per bone
        (HOP.py:136-139)."""
        return self.skeleton.n_bones


@dataclass(frozen=True)
class LLMConfig:
    """Frozen language-model backbone (reference run_ted.py:133-212):
    "BERT" (models.bert) or "LLAMA" (models.llama); anything else is
    rejected like the reference's 'LLM model is not defined'."""
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
    # self-attention route of the backbone (models.bert.BertLayer): "plain"
    # (matmul + softmax outside any kernel), "fused" (kernel K4) or "block"
    # (kernel K5); the port's counterpart of HOP_TPU_PALLAS_ATTN /
    # HOP_TPU_PALLAS_BLOCK_ATTN; LLaMA takes "plain" only
    attention: str = "plain"
    # LLaMA-specific (run_ted.py:133-175; ignored by the BERT path)
    n_kv_heads: int | None = None        # grouped-query attention
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6


def llama7b_llm_config(n_layers: int = 6) -> LLMConfig:
    """LLaMA-7B geometry truncated to n_layers, the reference's LLAMA
    option (run_ted.py:133-140 sets num_hidden_layers=args.llm_layers)."""
    return LLMConfig(model="LLAMA", dim=4096, n_layers=n_layers, n_heads=32,
                     intermediate_dim=11008, vocab_size=32000,
                     max_position=2048, rms_norm_eps=1e-6)


def tiny_llama_llm_config(n_layers: int = 2) -> LLMConfig:
    """A thin LLaMA for the CPU tests and `--tiny` runs: the 7B's topology
    (RMSNorm, RoPE, SwiGLU, causal, grouped-query with 2 kv heads) at
    tiny_test_config's backbone widths."""
    return LLMConfig(model="LLAMA", dim=64, n_layers=n_layers, n_heads=4,
                     n_kv_heads=2, intermediate_dim=128, vocab_size=128,
                     max_position=64)


@dataclass(frozen=True)
class HOPConfig:
    """HOP generator hyperparameters (reference model/HOP.py:72-174)."""
    d_model: int = 128                   # mel bins == reprogramming query dim
    n_heads: int = 8
    d_ff: int = 128                      # per-head key dim of reprogramming
    num_prototype_tokens: int = 1500
    # ablations: without gwnet the head reads the seed poses and WavEncoder
    # features; without reprogramming the backbone reads the text alone
    use_gwnet: bool = True
    use_reprogramming: bool = True
    # True: the fused GAN step (one generator forward, one backward); False:
    # the reference's 3-forward step (train.llm)
    fused_step: bool = True
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
    # GRU route of the head and the discriminator (ops.gru.GRU): "fused"
    # (kernel K2) or "stack" (one projection product + kernel K3); the
    # port's counterpart of HOP_TPU_PALLAS_GRU / HOP_TPU_GRU_BF16_STREAMS
    gru_kernel: str = "fused"
    gru_bf16_streams: bool = False


@dataclass(frozen=True)
class BaselineConfig:
    """Hyperparameters of the baseline zoo (hop_tpu/config.py:132-145): the
    upstream Trimodal defaults its nets assume, and the expressive feature
    net's latent width. hop_tpu's `freeze_wordembed`, `gan_noise_size` and
    `pose_level` are left out: nothing in the port reads them (the cascade's
    depth is its stage table's length)."""
    hidden_size: int = 300
    n_layers: int = 4
    dropout_prob: float = 0.3
    input_context: str = "both"          # both | audio | text | none
    motion_ae_latent_dim: int = 128


@dataclass(frozen=True)
class LossConfig:
    """Loss weights of the HOP train step and the epoch of its GAN gate
    (reference run_ted.py:89-92 / run_expressive.py:86-89)."""
    regression_weight: float = 600.0
    gan_weight: float = 5.0
    kld_weight: float = 0.6
    reg_weight: float = 0.4              # diversity regulariser
    warmup_epochs: int = 10              # GAN gate: epoch > 10 (train_llm.py:15)
    bc_start_epoch: int = 35             # BC gate: epoch > 35 (Evaluate.py:175)
    huber_beta: float = 0.1
    div_beta: float = 0.05
    div_clamp: float = -1000.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    epochs: int = 75
    learning_rate: float = 0.01          # generator Adam lr (run_ted.py:338)
    dis_lr_scale: float = 0.1            # D lr = G lr * 0.1 (run_ted.py:344-346)
    betas: tuple = (0.5, 0.999)
    seed: int = 2021
    grad_clip_seq2seq: float = 5.0       # global-norm clip (train_seq2seq.py:48)


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    hop: HOPConfig = field(default_factory=HOPConfig)
    baseline: BaselineConfig = field(default_factory=BaselineConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def ted_config() -> Config:
    """TED Gesture preset."""
    return Config()


def expressive_config() -> Config:
    """TED Expressive preset (reference run_expressive.py:81-100)."""
    return Config(data=DataConfig(dataset="TED_expressive"),
                  loss=LossConfig(regression_weight=2100.0, gan_weight=5.0,
                                  kld_weight=0.8, reg_weight=0.5),
                  train=TrainConfig(learning_rate=0.005))


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
        baseline=dataclasses.replace(base.baseline, hidden_size=32, n_layers=2),
        train=dataclasses.replace(base.train, batch_size=4),
    )
