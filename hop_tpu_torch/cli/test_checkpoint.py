"""Inference entry point (port of hop_tpu/cli/test_checkpoint.py).

Synthesises long-form gestures for a clip by sliding 34-frame windows with
16-frame feedback and a 4-frame cross-fade, and prints "generated N
frames". The clip is a seeded synthetic one (--data synthetic), or clip
--clip-index of a source LMDB of the reference's (--data <LMDB>, read by
`data.import_ted.iter_source_videos`, decoded only up to that clip): its
raw audio and words, the vocabulary over its words, and as the seed pose
its own resampled ground truth as dir-vecs minus the mean. With --evaluate
it then runs the validation pass (hop_tpu's test_checkpoint.py:133-158):
the source clips (seeded synthetic ones, or the LMDB's videos read)
through the preprocessor into a record store, `SpeechMotionDataset`
batches through `device_batch`, the generator's forward, and L1, joint
MAE, FGD, feature distance, BC and diversity (`eval.evaluate_testset`),
printed as hop_tpu's "[VAL] ..." line. With --render-video it renders the
stitched clip as `demo_0.mp4` (ffmpeg on PATH) or `demo_0.gif` and
`demo_0.wav` into the directory --out (default ./output), through
`utils.render` (hop_tpu's test_checkpoint.py:164-170). The FGD feature
net is read from --eval-net (hop_tpu's `save_arrays` .npz) or randomly
initialised, and said so. With --checkpoint-dir the generator is the latest checkpoint
that `cli.train_main` saved there (`cli.common.restore_hop_model`: the
frozen backbone rebuilt from the run's seed); without one, or where the
directory holds none, it is a seeded random initialisation, said so.

  python -m hop_tpu_torch.cli.test_checkpoint --device cuda
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --checkpoint-dir ./checkpoints
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --gru-kernel stack
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --bert-attention block
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda --evaluate
  python -m hop_tpu_torch.cli.test_checkpoint --device cuda \
      --data data/ted_dataset/lmdb_test --clip-index 3 --checkpoint-dir ./checkpoints
  python -m hop_tpu_torch.cli.test_checkpoint --device cpu --tiny --clip-seconds 3
  python -m hop_tpu_torch.cli.test_checkpoint --device cpu --tiny --render-video --out demo
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

from hop_tpu_torch import geometry
from hop_tpu_torch.cli import common as C
from hop_tpu_torch.config import expressive_config, ted_config, tiny_test_config
from hop_tpu_torch.data.dataset import SpeechMotionDataset
from hop_tpu_torch.data.import_ted import iter_source_videos
from hop_tpu_torch.data.preprocessor import DataPreprocessor, SourceClip
from hop_tpu_torch.data.synthetic import make_clip, make_source_clips
from hop_tpu_torch.data.vocab import build_vocab
from hop_tpu_torch.eval.evaluate import EvalResult, evaluate_testset
from hop_tpu_torch.infer import generate_long_form, make_forward
from hop_tpu_torch.models.hop import HOPModel, build_hop_model
from hop_tpu_torch.utils.render import create_video_and_save

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
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or a source-LMDB path (the reference "
                        "pulls a raw clip from the test LMDB, "
                        "test_checkpoint.py:325-349)")
    p.add_argument("--clip-index", type=int, default=0,
                   help="which clip of --data to synthesise, counted over "
                        "the LMDB's videos in key order")
    p.add_argument("--clip-seconds", type=float, default=20.0,
                   help="length of the synthetic clip (--data synthetic)")
    p.add_argument("--vid", type=int, default=None,
                   help="speaker id; default drawn from --seed")
    p.add_argument("--seed", type=int, default=2021,
                   help="seeds the clip, the weights and the latent noise")
    p.add_argument("--out", default=None,
                   help="save the dir-vecs to <out>_dir_vec.npy; with "
                        "--render-video, the directory of the video")
    p.add_argument("--render-video", action="store_true",
                   help="render the generated clip as demo_0.mp4 (ffmpeg) or "
                        "demo_0.gif + demo_0.wav into --out")
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
                        "records (26 windows each: 20 give 520), with "
                        "--data synthetic")
    return p.parse_args(argv)


def read_source_clip(path: str, clip_index: int):
    """(clip, videos): clip `clip_index` of the source LMDB at `path`,
    counted over its videos' clips in key order, and the videos read up to
    and including its own. Decoding stops there: a real LMDB is several GB.
    An index past the last clip exits with the count of clips seen."""
    videos, n_seen = [], 0
    for vid, clips in iter_source_videos(path):
        videos.append((vid, clips))
        if clip_index < n_seen + len(clips):
            return clips[clip_index - n_seen], videos
        n_seen += len(clips)
    raise SystemExit(f"--clip-index {clip_index} out of range ({n_seen} clips in {path})")


def clip_seed_dir_vec(cfg, clip: SourceClip) -> np.ndarray:
    """The seed pose of a source clip (hop_tpu's test_checkpoint.py:
    100-110): its skeletons resampled to the config's fps, the first
    n_seed_frames as dir-vecs, minus the dataset's mean dir-vec,
    (n_seed_frames, pose_dim)."""
    d, skel = cfg.data, cfg.data.skeleton
    skeletons = geometry.resample_pose_seq(
        clip.skeletons_3d, clip.end_time - clip.start_time, d.pose_resampling_fps)
    seed = geometry.convert_pose_seq_to_dir_vec(
        torch.from_numpy(np.asarray(skeletons[:d.n_seed_frames], np.float32)),
        skel).numpy().reshape(d.n_seed_frames, -1)
    if skel.mean_dir_vec is not None:
        seed = seed - skel.mean_dir_vec
    return seed


def evaluate(cfg, args, model: HOPModel, lang, tokenizer,
             device: torch.device, n_speakers: int = N_SPEAKERS,
             videos=None) -> EvalResult:
    """The validation pass: records written from `videos` ((vid, [SourceClip,
    ...]) pairs; by default --eval-videos seeded 20 s synthetic source
    clips, seed --seed), batches of --eval-batch-size in order through
    `device_batch`, the model's forward seeded with each batch's first 16
    target frames, speaker ids drawn from a generator seeded 7, the metrics
    at epoch bc_start_epoch + 1 (so BC is computed)."""
    if videos is None:
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
    if args.data == "synthetic":
        clip = make_clip(cfg, seconds=args.clip_seconds, seed=args.seed)
        audio, words, seed_vec, videos = clip.audio, clip.words, clip.seed_dir_vec, None
    else:
        clip, videos = read_source_clip(args.data, args.clip_index)
        audio, words, seed_vec = clip.audio_raw, clip.words, clip_seed_dir_vec(cfg, clip)
        print(f"clip {args.clip_index} vid={clip.vid} "
              f"({clip.end_time - clip.start_time:.1f}s, {len(words)} words)")
    lang = build_vocab("words", [words], None, None, cfg.data.wordembed_dim)
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
        cfg, make_forward(model), audio, words, seed_vec,
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
        print(str(evaluate(cfg, args, model, lang, tokenizer, device, n_speakers,
                           videos)))
    if args.render_video:
        skel = cfg.data.skeleton
        create_video_and_save(
            args.out or "output", 0, "demo", None, out_dir_vec,
            skel.mean_dir_vec if skel.mean_dir_vec is not None
            else np.zeros(cfg.data.pose_dim), title="HOP (PyTorch) demo",
            skeleton=skel, audio=audio)
    return out_dir_vec


if __name__ == "__main__":
    main()
