"""hop_tpu_torch — the HOP gesture generator in PyTorch with CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `hop_tpu` (JAX/Pallas) that keeps its module layout, so each
module's counterpart sits at the same path:

  config       — jax-free copy of the data / LLM / HOP / loss / train presets
  ops          — log-mel frontend, dropout bits, reprogramming attention
                 (K1) and the fused GRU layer (K2): each kernel a
                 hand-written CUDA forward and backward with its plain
                 PyTorch versions beside it
  models       — BERT backbone, reprogramming, graph wavenet, HOPModel,
                 ConvDiscriminator
  train        — the fused HOP GAN train step and its optimizers
  data         — seeded synthetic clips, training batches, the word index
  convert      — flax variable trees (numpy leaves) -> this port's
                 state_dicts
  infer        — long-form sliding-window generation
  cli          — `python -m hop_tpu_torch.cli.test_checkpoint`

The package imports torch and never jax, flax or `hop_tpu`.
"""

__version__ = "0.1.0"
