"""Inference entry point (port of hop_tpu/cli/test_checkpoint.py).

Synthesises long-form gestures for a seeded synthetic clip by sliding
34-frame windows with 16-frame feedback and a 4-frame cross-fade, and
prints "generated N frames". With --evaluate it then runs the validation
pass (hop_tpu's test_checkpoint.py:133-158): seeded synthetic source clips
through the preprocessor into a record store, `SpeechMotionDataset`
batches through `device_batch`, the generator's forward, and L1, joint
MAE, FGD, feature distance, BC and diversity (`eval.evaluate_testset`),
printed as hop_tpu's "[VAL] ..." line. The FGD feature net is read from
--eval-net (hop_tpu's `save_arrays` .npz) or randomly initialised, and
said so. With --checkpoint-dir the generator is the latest checkpoint
that `cli.train_main` saved there (`cli.common.restore_hop_model`: the
frozen backbone rebuilt from the run's seed); without one, or where the
directory holds none, it is a seeded random initialisation, said so.

  python -m hop_tpu_torch.cli.test_checkpoint --device cuda
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --checkpoint-dir ./checkpoints
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --gru-kernel stack
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --bert-attention block
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --evaluate
  python -m hop_tpu_torch.cli.test_checkpoint --device cpu --tiny --clip-seconds 3
  python -m hop_tpu_torch.cli.test_checkpoint --device cpu --tiny --clip-seconds 2 \
      --evaluate --eval-videos 1
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import tempfile
import time

import numpy as np
import torch

from hop_tpu_torch.cli import common as C
from hop_tpu_torch.config import expressive_config, ted_config, tiny_test_config
from hop_tpu_torch.data.dataset import SpeechMotionDataset
from hop_tpu_torch.data.preprocessor import DataPreprocessor
from hop_tpu_torch.data.synthetic import make_clip, make_source_clips
from hop_tpu_torch.data.vocab import build_vocab
from hop_tpu_torch.eval.evaluate import EvalResult, evaluate_testset
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
        llm=dataclasses.replace(cfg.llm, attention=args.bert_attention),
        data=dataclasses.replace(cfg.data,
                                 use_hf_token_stream=args.use_hf_token_stream))


def parse_args(argv=None):
    p = argparse.ArgumentParser("HOP (PyTorch) inference demo")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' runs the CUDA kernels")
    p.add_argument("--checkpoint-dir", default=None,
                   help="restore the generator from the latest checkpoint of a "
                        "training run (cli.run_ted); default a seeded random "
                        "init")
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
    p.add_argument("--use-hf-token-stream", action="store_true",
                   help="drive the LLM with WordPiece token ids (requires "
                        "--hf-vocab; reference test_checkpoint.py:438-446)")
    p.add_argument("--hf-vocab", default=None,
                   help="WordPiece vocab.txt for --use-hf-token-stream")
    p.add_argument("--evaluate", action="store_true",
                   help="after generation, run the validation metrics "
                        "(L1/MAE/FGD/BC/diversity) like the reference's "
                        "test_checkpoint.py:526-545")
    p.add_argument("--eval-net", default=None,
                   help=".npz of the frozen FGD feature net's flax variables "
                        "(hop_tpu's save_arrays format) for --evaluate; a "
                        "random init is used, and said so, when absent")
    p.add_argument("--eval-batch-size", type=int, default=None,
                   help="validation batch size (default: the config's "
                        "train.batch_size, 256 at TED)")
    p.add_argument("--eval-videos", type=int, default=20,
                   help="seeded 20 s synthetic source videos of the validation "
                        "records (26 windows each: 20 give 520)")
    return p.parse_args(argv)


def evaluate(cfg, args, model: HOPModel, lang, tokenizer,
             device: torch.device, n_speakers: int = N_SPEAKERS) -> EvalResult:
    """The validation pass: records written from --eval-videos seeded 20 s
    source clips (seed --seed), batches of --eval-batch-size in order
    through `device_batch`, the model's forward seeded with each batch's
    first 16 target frames, speaker ids drawn from a generator seeded 7,
    the metrics at epoch bc_start_epoch + 1 (so BC is computed)."""
    videos = make_source_clips(cfg, n_videos=args.eval_videos,
                               clip_seconds=20.0, seed=args.seed)
    evaluator = C.make_fgd_evaluator(cfg, lang.n_words, args.eval_net, device)
    n_seed = cfg.data.n_seed_frames

    def gen(batch, vids, generator):
        with torch.inference_mode():
            return model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                         batch["target_vec"][:, :n_seed], vids,
                         generator=generator)[0]

    batch_size = args.eval_batch_size or cfg.train.batch_size
    with tempfile.TemporaryDirectory(prefix="hop_eval_") as tmp:
        DataPreprocessor(cfg.data, tmp + "/val").run(videos)
        val_ds = SpeechMotionDataset(tmp + "/val", cfg.data, tokenizer=tokenizer)
        val_ds.set_lang_model(lang)
        print(f"evaluate: {len(val_ds)} windows in batches of {batch_size}, "
              f"{'native' if val_ds.reader.native else 'numpy'} gather")
        result = evaluate_testset(
            (C.device_batch(b, cfg, device=device)
             for b in val_ds.batches(batch_size, shuffle=False, drop_last=False)),
            gen, evaluator, epoch=cfg.loss.bc_start_epoch + 1, cfg=cfg,
            n_speakers=n_speakers,
            generator=torch.Generator(device=device).manual_seed(7))
    return result


def main(argv=None, model: HOPModel | None = None) -> np.ndarray:
    """Run the demo; `model` (built for the same config and device) skips
    building one from --seed."""
    args = parse_args(argv)
    tokenizer = C.make_tokenizer(args)
    cfg = config_from_args(args)
    device = torch.device(args.device)
    clip = make_clip(cfg, seconds=args.clip_seconds, seed=args.seed)
    lang = build_vocab("words", [clip.words], None, None, cfg.data.wordembed_dim)
    n_speakers = N_SPEAKERS
    if model is None and args.checkpoint_dir:
        cfg, model, n_speakers = C.restore_hop_model(
            cfg, args.checkpoint_dir, allow_random_init=True, device=device,
            seed=args.seed)
    elif model is None:
        print(f"no --checkpoint-dir — using random init (seed {args.seed})")
        model = build_hop_model(cfg, N_SPEAKERS, args.seed, device)
    model.eval()
    vid_index = (args.vid if args.vid is not None
                 else random.Random(args.seed).randrange(n_speakers))
    print(f"vid: {vid_index}")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out_dir_vec = generate_long_form(
        cfg, make_forward(model), clip.audio, clip.words, clip.seed_dir_vec,
        lang, vid_index=vid_index, tokenizer=tokenizer, generator=generator,
        device=device)
    seconds = time.perf_counter() - t0
    fps = cfg.data.pose_resampling_fps
    print(f"generated {out_dir_vec.shape[0]} frames "
          f"({out_dir_vec.shape[0] / fps:.1f}s) in {seconds * 1e3:.1f} ms "
          f"on {device}")
    if args.out:
        np.save(f"{args.out}_dir_vec.npy", out_dir_vec)
    if args.evaluate:
        print(str(evaluate(cfg, args, model, lang, tokenizer, device, n_speakers)))
    return out_dir_vec


if __name__ == "__main__":
    main()
