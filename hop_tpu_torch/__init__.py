"""hop_tpu_torch — the HOP gesture generator in PyTorch with CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `hop_tpu` (JAX/Pallas) that keeps its module layout, so each
module's counterpart sits at the same path:

  config       — jax-free copy of the data / LLM / HOP presets
  ops          — log-mel frontend, reprogramming attention (K1) and the
                 fused GRU layer (K2): each a hand-written CUDA kernel with
                 its plain PyTorch version beside it
  models       — BERT backbone, reprogramming, graph wavenet, HOPModel
  data         — seeded synthetic clips and the word index
  convert      — flax variable tree (numpy leaves) -> this port's state_dict
  infer        — long-form sliding-window generation
  cli          — `python -m hop_tpu_torch.cli.test_checkpoint`

The package imports torch and never jax, flax or `hop_tpu`.
"""

__version__ = "0.1.0"
