"""What the entry points share (port of hop_tpu/cli/common.py): the host
batch -> device batch path (:318-396), the WordPiece tokenizer, the
datasets, the frozen FGD feature net and the validation pass's closure
(:265-467).

`device_batch` takes a batch of numpy arrays as the data loader makes it,
moves the fields a model reads to the device and derives there what the
model needs beside them: the per-sample log-mel from the raw audio, the
word mask, and the text ids clamped into the backbone's vocabulary. Raw
audio, the batch's largest field, can cross at 16 bits
(`DataConfig.audio_wire="int16"`). Every host array goes through pinned
memory in one explicit asynchronous copy.

`load_datasets` has hop_tpu's synthetic and record-path branches; its
fastText `.bin` word-vector source comes with the dataset importers.
`make_eval_fn` assembles and moves each validation batch in turn (hop_tpu
can overlap them in a background thread: the training loop's prefetch).
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hop_tpu_torch import convert
from hop_tpu_torch.config import Config
from hop_tpu_torch.data import synthetic
from hop_tpu_torch.data.dataset import SpeechMotionDataset
from hop_tpu_torch.data.preprocessor import DataPreprocessor
from hop_tpu_torch.data.vocab import build_vocab
from hop_tpu_torch.eval.evaluate import evaluate_testset
from hop_tpu_torch.eval.fgd import (EmbeddingSpaceEvaluator, make_expressive_feature_fn,
                                    make_ted_feature_fn)
from hop_tpu_torch.models.embedding_net import EmbeddingNet
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.ops import mel as mel_ops

#: host fields each model family reads; transferring only these cuts the
#: per-batch host-to-device volume (AD_LLM skips the spectrogram and the
#: pose_seq/word streams)
MODEL_BATCH_KEYS = {
    "AD_LLM": ("in_audio", "target_vec", "vid_indices", "text_padded",
               "text_tokens"),
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
        batch = {k: v for k, v in batch.items() if k in keys}
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
    20 s source clips; the first video is the validation split) or the
    path of a record store (`args.val_data` for another validation one)."""
    tokenizer = make_tokenizer(args)
    source = getattr(args, "wordembed_path", None)
    if source and source.endswith(".bin"):
        raise SystemExit("--wordembed-path: a fastText .bin needs the dataset "
                         "importers, not ported yet; give a .npy or .txt/.vec")
    if args.data == "synthetic":
        tmp = Path(tempfile.mkdtemp(prefix="hop_synth_"))
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
                 n_speakers: int, device: torch.device | str = "cuda"):
    """eval_fn(state, epoch) -> EvalResult over `val_ds` in order at
    cfg.train.batch_size, the last batch ragged;
    generate_from_state(state, batch, vids, generator) -> outputs. The
    speaker ids of epoch e come from a generator seeded 1234 + e."""

    def eval_fn(state, epoch):
        batches = (device_batch(b, cfg, device=device)
                   for b in val_ds.batches(cfg.train.batch_size, shuffle=False,
                                           drop_last=False))

        def gen(batch, vids, generator):
            return generate_from_state(state, batch, vids, generator)
        generator = torch.Generator(device=device).manual_seed(1234 + epoch)
        return evaluate_testset(batches, gen, evaluator, epoch, cfg,
                                n_speakers, generator=generator)
    return eval_fn
