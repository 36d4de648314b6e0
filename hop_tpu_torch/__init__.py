"""hop_tpu_torch — the HOP gesture generator in PyTorch with CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `hop_tpu` (JAX/Pallas) that keeps its module layout, so each
module's counterpart sits at the same path:

  config       — jax-free copy of the data / LLM / HOP / loss / train presets
  geometry     — skeleton tables, forward kinematics, pose <-> dir-vec
  ops          — log-mel frontend, dropout bits, onset detection, the
                 eigh-based matrix square root, and the kernels K1-K6:
                 each a hand-written CUDA kernel with its plain PyTorch
                 versions beside it
  models       — BERT backbone, reprogramming, graph wavenet, HOPModel,
                 ConvDiscriminator, the FGD feature nets (EmbeddingNet in
                 pose mode, MotionAE)
  train        — the HOP GAN train steps, their optimizers and the epoch
                 loop (prefetch, validation, save-on-best-FGD)
  utils        — checkpoints, the per-step random generator, meters, the
                 video renderer, the TensorBoard / CSV metric export, the
                 profiler trace and step timer, the reference's tools
  data         — record store, preprocessor, SpeechMotionDataset,
                 vocabulary, WordPiece, seeded synthetic clips and batches
  native       — the record store's C++ batch gatherer (g++ at first use)
  eval         — the validation pass: L1, joint MAE, FGD, BC, diversity;
                 reference-format checkpoints out and in
  convert      — flax variable trees (numpy leaves, or hop_tpu's flat
                 .npz) -> this port's state_dicts
  infer        — the serving export (torch.export, the kernels as
                 registered operators) and long-form generation
  cli          — `python -m hop_tpu_torch.cli.run_ted` / `run_expressive`
                 (training), `python -m hop_tpu_torch.cli.test_checkpoint`
                 and `python -m hop_tpu_torch.cli.export_model`

The package imports torch and never jax, flax or `hop_tpu`.
"""

__version__ = "0.1.0"
