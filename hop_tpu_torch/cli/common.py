"""What the entry points share (port of hop_tpu/cli/common.py): the
training entry points' parser and config overrides (:41-156, :233-262),
the restore of a trained generator (:159-230) with its frozen backbone,
BERT or LLaMA, random or pretrained (`--llm-weights`), the host batch -> device
batch path (:318-396), the WordPiece tokenizer, the datasets, the frozen
FGD feature net and the validation pass's closure (:265-467).

`base_parser` has every flag of hop_tpu's. The parallel flags
(`--data-parallel`, `--model-parallel`, `--dcn-slices`, `--no-zero2`) ask
for a run of one process a rank under torchrun (`parallel.init_distributed`).
The port adds `--device` (default cuda: the card, never a silent move to
the CPU), `--gru-kernel`, `--bert-attention`, `--tiny` and, for a rank,
`--dist-backend` (what `--device` is to a tensor).

`device_batch` takes a batch of numpy arrays as the data loader makes it,
moves the fields a model reads to the device and derives there what the
model needs beside them: the per-sample log-mel from the raw audio, the
word mask, and the text ids clamped into the backbone's vocabulary. Raw
audio, the batch's largest field, can cross at 16 bits
(`DataConfig.audio_wire="int16"`). Every host array goes through pinned
memory in one explicit asynchronous copy.

`load_datasets` has hop_tpu's synthetic and record-path branches and its
word-vector sources: a .npy matrix, a .txt/.vec file or a fastText .bin
(`data.fasttext_export.FastTextModel`). Records of the reference's LMDBs
come from `data.import_ted`.
`make_eval_fn` assembles and moves the validation batches in turn, or on a
background thread ahead of the forwards (`prefetch`, the training loop's
`prefetch_iter`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hop_tpu_torch import convert
from hop_tpu_torch.config import Config, LLMConfig, llama7b_llm_config, tiny_llama_llm_config
from hop_tpu_torch.data import synthetic
from hop_tpu_torch.data.dataset import SpeechMotionDataset
from hop_tpu_torch.data.fasttext_export import FastTextModel
from hop_tpu_torch.data.preprocessor import DataPreprocessor
from hop_tpu_torch.data.vocab import build_vocab
from hop_tpu_torch.eval.evaluate import evaluate_testset
from hop_tpu_torch.eval.fgd import (EmbeddingSpaceEvaluator, make_expressive_feature_fn,
                                    make_ted_feature_fn)
from hop_tpu_torch.models.embedding_net import EmbeddingNet
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.models.llm_weights import install_llm_weights
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.ops import mel as mel_ops
from hop_tpu_torch.parallel.mesh import GLOBAL_VIDS
from hop_tpu_torch.train.loops import prefetch_iter
from hop_tpu_torch.utils.checkpoint import (CheckpointManager, reattach_frozen,
                                            strip_frozen)

MODEL_CHOICES = ("AD_LLM", "multimodal_context", "seq2seq", "speech2gesture",
                 "joint_embedding", "gesture_autoencoder", "hierarchy")


def base_parser(description: str) -> argparse.ArgumentParser:
    """hop_tpu's training flags (cli/common.py:45-156) and the port's own."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", default="AD_LLM", choices=MODEL_CHOICES)
    p.add_argument("--data", default="synthetic",
                   help="record-store path prefix (train split), or "
                        "'synthetic' to fabricate one")
    p.add_argument("--val-data", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    p.add_argument("--metrics", default="./metrics.jsonl")
    p.add_argument("--tensorboard-dir", default=None,
                   help="also mirror the --metrics scalars live into a "
                        "TensorBoard event file in this directory")
    p.add_argument("--eval-net", default=None,
                   help=".npz of the frozen FGD feature net's flax variables "
                        "(hop_tpu's save_arrays format); random init, said so, "
                        "when absent")
    p.add_argument("--seed", type=int, default=2021,
                   help="seeds the weights, the synthetic data, the batch order "
                        "and every step's draws")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="data-parallel degree (0: WORLD_SIZE / (model x dcn)); "
                        "more than one rank runs under torchrun, one process a "
                        "rank, the batch split over dcn x data")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel degree for the frozen LLM backbone")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of train steps 2-5 of "
                        "the first epoch to <dir>/trace.json")
    p.add_argument("--dcn-slices", type=int, default=1,
                   help="outer 'dcn' axis of the rank layout: the batch is "
                        "split over dcn x data, ZeRO's moments over data alone")
    p.add_argument("--parity-step", action="store_true",
                   help="train HOP with the reference's 3-forward sequential "
                        "D/G step instead of the default fused step")
    p.add_argument("--no-zero2", action="store_true",
                   help="keep Adam's moments whole on every data rank (ZeRO-2 "
                        "analog, on by default when data > 1)")
    p.add_argument("--synthetic-videos", type=int, default=3)
    p.add_argument("--wordembed-path", default=None,
                   help="pretrained word vectors for the vocabulary: a .npy "
                        "matrix, a .txt/.vec file or a fastText .bin model")
    p.add_argument("--use-hf-token-stream", action="store_true",
                   help="feed WordPiece token ids to the LLM instead of the "
                        "reference's vocabulary ids; requires --hf-vocab")
    p.add_argument("--hf-vocab", default=None,
                   help="WordPiece vocab.txt for the HF token stream")
    p.add_argument("--llm-model", default=None, choices=("BERT", "LLAMA"),
                   help="frozen backbone for AD_LLM: BERT (default) or LLAMA, "
                        "LLaMA-7B's geometry (with --tiny a thin LLaMA)")
    p.add_argument("--llm-layers", type=int, default=None,
                   help="backbone depth (reference --llm_layers, default 6)")
    p.add_argument("--llm-weights", default=None,
                   help="pretrained backbone: an HF checkpoint directory "
                        "(config.json + model.safetensors, pytorch_model.bin "
                        "or a sharded *.index.json) or a state-dict file; "
                        "default a seeded random init")
    p.add_argument("--warmup-epochs", type=int, default=None,
                   help="generator-only epochs before the GAN phase starts "
                        "(the reference's gate `epoch > 10`, train_llm.py:15)")
    p.add_argument("--transfer-guard", default="off",
                   choices=("off", "log", "disallow"),
                   help="torch.cuda.set_sync_debug_mode warn / error around "
                        "the training hot loop: an operation there that makes "
                        "the host wait for the card warns or raises")
    p.add_argument("--audio-wire", default=None, choices=("f32", "int16"),
                   help="host->device wire dtype for raw audio, the batch's "
                        "largest field (DataConfig.audio_wire)")
    p.add_argument("--prefetch", type=int, default=0,
                   help="make up to N batches (host assembly and the copy to "
                        "the card) ahead on a background thread, for training "
                        "and for the validation pass (0 = in turn)")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save the latest-for-resume checkpoint every N epochs "
                        "(best-FGD epochs always save)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from --checkpoint-dir "
                        "before training (params, optimizer state, stats)")
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain versions")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="a rank's process-group backend (default: nccl on the "
                        "card, gloo on the CPU); gloo puts several ranks on one "
                        "card, which nccl refuses")
    p.add_argument("--tiny", action="store_true",
                   help="thin layers (tiny_test_config) for a quick CPU run")
    p.add_argument("--gru-kernel", default="fused", choices=("fused", "stack"),
                   help="GRU route of every GRU of the model (HOP's head, the "
                        "discriminator, the baselines'): the fused kernel (K2), "
                        "or a projection product + K3")
    p.add_argument("--bert-attention", default="plain",
                   choices=("plain", "fused", "block"),
                   help="self-attention route of the BERT backbone: matmul + "
                        "softmax, kernel K4, or kernel K5 (LLaMA: plain only)")
    return p


def apply_overrides(cfg: Config, args) -> Config:
    """hop_tpu's overrides (cli/common.py:233-262) and the port's routes, from
    `base_parser`'s arguments."""
    train = cfg.train
    if args.epochs is not None:
        train = dataclasses.replace(train, epochs=args.epochs)
    if args.batch_size is not None:
        train = dataclasses.replace(train, batch_size=args.batch_size)
    if args.learning_rate is not None:
        train = dataclasses.replace(train, learning_rate=args.learning_rate)
    loss, data, hop, llm = cfg.loss, cfg.data, cfg.hop, cfg.llm
    if args.warmup_epochs is not None:
        loss = dataclasses.replace(loss, warmup_epochs=args.warmup_epochs)
    if args.use_hf_token_stream:
        data = dataclasses.replace(data, use_hf_token_stream=True)
    if args.audio_wire:
        data = dataclasses.replace(data, audio_wire=args.audio_wire)
    if args.parity_step:
        hop = dataclasses.replace(hop, fused_step=False)
    if args.llm_model == "LLAMA":
        llm = llama_config(args.llm_layers or llm.n_layers, args.tiny)
        if args.bert_attention != "plain":
            raise SystemExit(
                f"--bert-attention {args.bert_attention} with --llm-model LLAMA: "
                "the kernel attention routes (K4, K5) are BERT's (no mask, head "
                "dim 64); LLaMA's attention is causal, head dim "
                f"{llm.dim // llm.n_heads}, and runs plain products")
    elif args.llm_layers:
        llm = dataclasses.replace(llm, n_layers=args.llm_layers)
    hop = dataclasses.replace(hop, gru_kernel=args.gru_kernel)
    llm = dataclasses.replace(llm, attention=args.bert_attention)
    return cfg.replace(train=train, loss=loss, data=data, hop=hop, llm=llm)


def llama_config(n_layers: int, tiny: bool) -> LLMConfig:
    """`--llm-model LLAMA`: LLaMA-7B's geometry, or with `--tiny` the thin
    LLaMA, at `n_layers` (hop_tpu/cli/common.py:256-261)."""
    return (tiny_llama_llm_config if tiny else llama7b_llm_config)(n_layers)


def install_backbone(model, path: str, llm: LLMConfig, hf_vocab: Optional[str] = None):
    """--llm-weights into `model.llm_model` (`models.llm_weights`), said so."""
    info = install_llm_weights(model, path, llm, hf_vocab)
    print(f"loaded pretrained {llm.model} backbone from {path} "
          f"({info['bytes'] / 2**20:.1f} MiB in {info['seconds']:.2f} s)")


def restore_hop_model(cfg: Config, checkpoint_dir: str, allow_random_init: bool = False,
                      device: torch.device | str = "cuda", seed: int = 2021):
    """Rebuild a HOPModel from a train_main checkpoint directory.

    Returns (cfg, model, n_speakers), the model in eval mode on `device`.
    The frozen backbone is stripped from checkpoints; it is rebuilt as
    `run_metadata.json` records it (`llm_model`, `llm_layers`, `llm_dim`:
    BERT at the caller's widths, or LLaMA, 7B or thin by the recorded
    width; the attention route of the caller's `cfg`) from the run's seed, the
    same init the run trained with, and, when the run was trained with
    --llm-weights, reloaded from that path (hop_tpu/cli/common.py:216-225):
    a random backbone would silently change every generated gesture. A path
    that no longer exists raises SystemExit. With `allow_random_init` and
    no checkpoint, the model is a random init from `seed` with 10 speakers,
    said so; without, it raises SystemExit, as it does for a checkpoint of
    another model family.
    """
    ckpt = CheckpointManager(checkpoint_dir)
    meta = ckpt.run_metadata()
    if meta.get("model", "AD_LLM") != "AD_LLM":
        raise SystemExit(f"{checkpoint_dir} holds a {meta['model']} checkpoint; the "
                         "long-form generator restores AD_LLM (HOP) checkpoints")
    if meta.get("llm_model") == "LLAMA":
        llm = llama_config(int(meta["llm_layers"]),
                           tiny=meta.get("llm_dim") == tiny_llama_llm_config().dim)
        cfg = cfg.replace(llm=dataclasses.replace(llm, attention=cfg.llm.attention))
    elif meta.get("llm_layers"):
        cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, n_layers=int(meta["llm_layers"])))
    if ckpt.latest_step() is None:
        if not allow_random_init:
            raise SystemExit(f"no checkpoint found in {checkpoint_dir}")
        print(f"no checkpoint found — using random init (seed {seed})")
        return cfg, build_hop_model(cfg, 10, seed, device), 10
    n_speakers = int(meta["n_speakers"])
    model = build_hop_model(cfg, n_speakers, int(meta["seed"]), device)
    llm_weights = meta.get("llm_weights")
    if llm_weights:
        if not os.path.exists(llm_weights):
            raise SystemExit(
                f"checkpoint was trained with --llm-weights {llm_weights}, "
                "which no longer exists; restore it (or copy the HF "
                "checkpoint back to that path) before inference")
        install_backbone(model, llm_weights, cfg.llm)
    saved = ckpt.restore()
    frozen = strip_frozen(model.state_dict())[1]
    model.load_state_dict(reattach_frozen(saved["gen"], frozen), strict=True)
    print(f"restored checkpoint step {ckpt.latest_step()}")
    return cfg, model.eval(), n_speakers

#: host fields each model family reads; transferring only these cuts the
#: per-batch host-to-device volume (AD_LLM skips the spectrogram and the
#: pose_seq/word streams)
MODEL_BATCH_KEYS = {
    "AD_LLM": ("in_audio", "target_vec", "vid_indices", "text_padded",
               "text_tokens"),
    "multimodal_context": ("in_audio", "target_vec", "vid_indices",
                           "text_padded"),
    "seq2seq": ("word_seq", "text_lengths", "target_vec"),
    "speech2gesture": ("spectrogram", "target_vec"),
    "joint_embedding": ("text_padded", "in_audio", "target_vec"),
    "gesture_autoencoder": ("target_vec",),
    "hierarchy": ("spectrogram", "text_padded", "target_vec", "vid_indices"),
}


def _put(array: np.ndarray, device) -> torch.Tensor:
    """One host array to `device`: from pinned memory, asynchronously, when
    that is a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _put_audio(audio: np.ndarray, wire: str, device) -> torch.Tensor:
    """Transfer raw audio at the configured wire dtype (DataConfig.audio_wire).

    "int16" quantizes on the host to the 16-bit PCM grid (i / 2^15) and
    dequantizes on the device, halving the volume of the batch's dominant
    tensor. Exact for PCM-derived audio; <= 2^-16 full-scale error and
    [-1, 1) saturation otherwise. The model always sees float32.
    """
    if wire == "int16":
        q = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
        return _put(q, device).to(torch.float32) * (1.0 / 32768.0)
    if wire != "f32":
        raise ValueError(f"audio_wire must be 'f32' or 'int16', got {wire!r}")
    return _put(audio, device)


def device_batch(batch: dict, cfg: Config, with_mel: bool = True, keys=None,
                 device: torch.device | str = "cuda") -> dict:
    """Host batch (numpy arrays) -> tensors on `device` + log-mel computed
    there.

    keys: optional subset of host fields to transfer (MODEL_BATCH_KEYS);
    derived tensors (log_mel, text_mask, the text_padded clamp) are computed
    when their sources are present.
    """
    if keys is not None:
        batch = {k: v for k, v in batch.items() if k in keys or k == GLOBAL_VIDS}
    # text ids are transferred once, after the clamp (below), not here too
    out = {k: _put(np.asarray(v), device) for k, v in batch.items()
           if k not in ("text_padded", "text_tokens", "in_audio")}
    if "in_audio" in batch:
        out["in_audio"] = _put_audio(np.asarray(batch["in_audio"]),
                                     cfg.data.audio_wire, device)
    if with_mel and "in_audio" in out:
        d = cfg.data
        out["log_mel"] = mel_ops.log_mel_spectrogram(
            out["in_audio"], sr=d.sample_rate, n_fft=d.mel_n_fft,
            hop=d.mel_hop, n_mels=d.mel_bins)
    if "word_seq" in batch and "text_lengths" in batch:
        T = batch["word_seq"].shape[1]
        out["text_mask"] = _put(
            (np.arange(T)[None] < np.asarray(batch["text_lengths"])[:, None])
            .astype(np.float32), device)
    # the live HOP path feeds vocabulary word ids as LLM token ids
    # (run_ted.py:400), clamped into the LLM vocabulary on the host;
    # use_hf_token_stream switches to the HF tokenizer's ids instead
    if cfg.data.use_hf_token_stream and "text_tokens" in batch:
        out["text_padded"] = _put(
            np.asarray(batch["text_tokens"]) % cfg.llm.vocab_size, device)
    elif "text_padded" in batch:
        out["text_padded"] = _put(
            np.asarray(batch["text_padded"]) % cfg.llm.vocab_size, device)
    return out


def make_tokenizer(args):
    """WordPiece tokenizer for the HF token stream, or None.

    The reference tokenizes every sample with BertTokenizer
    (lmdb_data_loader.py:155); without a vocab file the stream would
    silently be all zeros, so --use-hf-token-stream without --hf-vocab is
    an error."""
    vocab_path = getattr(args, "hf_vocab", None)
    if not getattr(args, "use_hf_token_stream", False):
        return None
    if not vocab_path:
        raise SystemExit(
            "--use-hf-token-stream needs --hf-vocab <vocab.txt>: without a "
            "WordPiece vocab the LLM token stream would be all zeros "
            "(the reference builds its tokenizer from the BERT artifact, "
            "run_ted.py:176-212)")
    from hop_tpu_torch.data.wordpiece import WordPieceTokenizer
    return WordPieceTokenizer(vocab_path)


def load_datasets(cfg: Config, args):
    """(train_ds, val_ds, lang_model). `args.data` is "synthetic" (records
    written to a temporary directory from `args.synthetic_videos` seeded
    20 s source clips; the first video is the validation split; the
    directory goes when the last of the two datasets does) or the path of a
    record store (`args.val_data` for another validation one), such as
    `data.import_ted` writes from the reference's LMDBs. The vocabulary's
    vectors come from `args.wordembed_path`: a .npy, a .txt/.vec or a
    fastText .bin."""
    tokenizer = make_tokenizer(args)
    records = None
    if args.data == "synthetic":
        records = tempfile.TemporaryDirectory(prefix="hop_synth_")
        tmp = Path(records.name)
        videos = synthetic.make_source_clips(
            cfg, n_videos=args.synthetic_videos, clip_seconds=20.0,
            seed=args.seed)
        for split, vids in (("train", videos), ("val", videos[:1])):
            DataPreprocessor(cfg.data, str(tmp / split)).run(vids)
        train_path, val_path = str(tmp / "train"), str(tmp / "val")
    else:
        train_path = args.data
        val_path = getattr(args, "val_data", None) or args.data

    train_ds = SpeechMotionDataset(train_path, cfg.data, tokenizer=tokenizer)
    val_ds = SpeechMotionDataset(val_path, cfg.data,
                                 speaker_model=train_ds.speaker_model,
                                 tokenizer=tokenizer)
    # the datasets hold the synthetic records' directory; it is removed when
    # neither of them is referenced any more (or at exit)
    train_ds.records_dir = val_ds.records_dir = records
    source = getattr(args, "wordembed_path", None)
    if source and source.endswith(".bin"):
        source = FastTextModel(source).get_word_vector
    lang = build_vocab(
        "words",
        [[w for aux in ds._aux_cache for w in aux["words"]]
         for ds in (train_ds, val_ds)],
        None, source, cfg.data.wordembed_dim)
    train_ds.set_lang_model(lang)
    val_ds.set_lang_model(lang)
    return train_ds, val_ds, lang


def make_fgd_evaluator(cfg: Config, lang_n_words: int,
                       eval_net_path: Optional[str],
                       device: torch.device | str = "cuda") -> EmbeddingSpaceEvaluator:
    """The frozen feature net -> EmbeddingSpaceEvaluator, on `device`.

    `eval_net_path`: the flat .npz that hop_tpu's `save_arrays` writes of
    the flax net's variables, converted to the port's state_dict. Without
    it the net is randomly initialised from seed 0, said so loudly, and
    FGD is then comparable only within a run (the reference loads
    gesture_autoencoder_checkpoint_best.bin, run_ted.py:126)."""
    pose_dim = cfg.data.pose_dim
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if pose_dim == 27:
            net = EmbeddingNet(pose_dim=pose_dim, n_frames=cfg.data.n_poses,
                               n_words=lang_n_words, mode="pose")
            to_state_dict = convert.embedding_net_state_dict_from_jax
            make_fn = make_ted_feature_fn
        else:
            net = MotionAE(pose_dim=pose_dim,
                           latent_dim=cfg.baseline.motion_ae_latent_dim)
            to_state_dict = convert.motion_ae_state_dict_from_jax
            make_fn = make_expressive_feature_fn
    if eval_net_path:
        net.load_state_dict(
            to_state_dict(convert.load_npz_variables(eval_net_path)), strict=True)
    else:
        _warn_untrained_eval_net()
    net = net.to(device).eval().requires_grad_(False)
    return EmbeddingSpaceEvaluator(make_fn(net), trained=bool(eval_net_path))


def _warn_untrained_eval_net():
    print("WARNING: no --eval-net weights; the FGD feature net is RANDOMLY "
          "INITIALISED.\n         FGD/diversity below are relative numbers "
          "for this run only — NOT\n         comparable to the reference "
          "(convert gesture_autoencoder_checkpoint\n         _best.bin with "
          "hop_tpu's eval/torch_import.py and save_arrays for parity numbers).")


def make_eval_fn(cfg: Config, val_ds, evaluator, generate_from_state,
                 n_speakers: int, device: torch.device | str = "cuda",
                 prefetch: int = 0, mesh=None):
    """eval_fn(state, epoch) -> EvalResult over `val_ds` in order at
    cfg.train.batch_size, the last batch ragged;
    generate_from_state(state, batch, vids, generator) -> outputs. The
    speaker ids of epoch e come from a generator seeded 1234 + e.

    prefetch: make and move up to N validation batches ahead of the
    forwards on a background thread (`prefetch_iter`). mesh: a rank of a
    parallel run (`evaluate_testset`'s mesh branch)."""

    def eval_fn(state, epoch):
        batches = prefetch_iter(
            (device_batch(b, cfg, device=device)
             for b in val_ds.batches(cfg.train.batch_size, shuffle=False,
                                     drop_last=False)),
            prefetch)

        def gen(batch, vids, generator):
            return generate_from_state(state, batch, vids, generator)
        generator = torch.Generator(device=device).manual_seed(1234 + epoch)
        return evaluate_testset(batches, gen, evaluator, epoch, cfg,
                                n_speakers, generator=generator, mesh=mesh)
    return eval_fn
