"""Inference entry point (port of hop_tpu/cli/test_checkpoint.py).

Synthesises long-form gestures for a seeded synthetic clip by sliding
34-frame windows with 16-frame feedback and a 4-frame cross-fade, and
prints "generated N frames". The model is built from a seeded random
initialisation; restoring a trained checkpoint comes with the training
slice (ROADMAP M10).

  python -m hop_tpu_torch.cli.test_checkpoint --device cuda
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --gru-kernel stack
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --bert-attention block
  python -m hop_tpu_torch.cli.test_checkpoint --device cpu --tiny --clip-seconds 3
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import time

import numpy as np
import torch

from hop_tpu_torch.config import expressive_config, ted_config, tiny_test_config
from hop_tpu_torch.data.synthetic import WordIndex, make_clip
from hop_tpu_torch.infer import generate_long_form, make_forward
from hop_tpu_torch.models.hop import HOPModel, build_hop_model

# speakers of a randomly initialised model (hop_tpu's restore_hop_model
# default when a checkpoint records none)
N_SPEAKERS = 10


def config_from_args(args):
    if args.tiny:
        cfg = tiny_test_config(args.dataset)
    else:
        cfg = ted_config() if args.dataset == "TED" else expressive_config()
    return cfg.replace(
        hop=dataclasses.replace(cfg.hop, gru_kernel=args.gru_kernel),
        llm=dataclasses.replace(cfg.llm, attention=args.bert_attention))


def parse_args(argv=None):
    p = argparse.ArgumentParser("HOP (PyTorch) inference demo")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' runs the CUDA kernels")
    p.add_argument("--dataset", default="TED",
                   choices=("TED", "TED_expressive"))
    p.add_argument("--tiny", action="store_true",
                   help="thin layers (tiny_test_config) for a quick CPU run")
    p.add_argument("--gru-kernel", default="fused", choices=("fused", "stack"),
                   help="GRU route of the head: the fused kernel (K2), or one "
                        "projection product per layer + the time-grid kernel (K3)")
    p.add_argument("--bert-attention", default="plain",
                   choices=("plain", "fused", "block"),
                   help="self-attention route of the backbone: matmul + softmax, "
                        "the per-(sample, head) kernel (K4), or the stacked "
                        "block-diagonal kernel (K5)")
    p.add_argument("--clip-seconds", type=float, default=20.0)
    p.add_argument("--vid", type=int, default=None,
                   help="speaker id; default drawn from --seed")
    p.add_argument("--seed", type=int, default=2021,
                   help="seeds the clip, the weights and the latent noise")
    p.add_argument("--out", default=None,
                   help="save the dir-vecs to <out>_dir_vec.npy")
    return p.parse_args(argv)


def main(argv=None, model: HOPModel | None = None) -> np.ndarray:
    """Run the demo; `model` (built for the same config and device) skips
    building one from --seed."""
    args = parse_args(argv)
    cfg = config_from_args(args)
    device = torch.device(args.device)
    clip = make_clip(cfg, seconds=args.clip_seconds, seed=args.seed)
    lang = WordIndex(clip.words)
    if model is None:
        model = build_hop_model(cfg, N_SPEAKERS, args.seed, device)
    vid_index = (args.vid if args.vid is not None
                 else random.Random(args.seed).randrange(N_SPEAKERS))
    print(f"vid: {vid_index}")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out_dir_vec = generate_long_form(
        cfg, make_forward(model), clip.audio, clip.words, clip.seed_dir_vec,
        lang, vid_index=vid_index, generator=generator, device=device)
    seconds = time.perf_counter() - t0
    fps = cfg.data.pose_resampling_fps
    print(f"generated {out_dir_vec.shape[0]} frames "
          f"({out_dir_vec.shape[0] / fps:.1f}s) in {seconds * 1e3:.1f} ms "
          f"on {device}")
    if args.out:
        np.save(f"{args.out}_dir_vec.npy", out_dir_vec)
    return out_dir_vec


if __name__ == "__main__":
    main()
