"""Training dataset over the record store: clipping, alignment, batching
(port of hop_tpu/data/dataset.py; host numpy).

Counterpart of reference data_loader/lmdb_data_loader.py:25-273
(SpeechMotionDataset + default_collate_fn), redesigned for device feeding:

  * fixed 34-frame windows are clipped from the stored extended windows and
    audio padded to 36267 samples exactly as the reference does
    (:205-210);
  * word-to-frame alignment (both the fasttext-vocab stream and an optional
    HF-tokenizer stream) follows :129-200, including the evenly-spaced
    variant when remove_word_timing is set and its `int(n_frames/(n_words+
    1))` spacing;
  * the per-sample librosa mel computation (:216-218) is REMOVED from the
    hot path — batches carry raw audio and the log-mel is computed on
    the device, batched, by `cli.common.device_batch` (ops/mel.py);
  * batch assembly is one contiguous gather (the C++ gatherer, or its
    numpy twin: `reader.native`) instead of per-sample worker
    deserialisation.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np

from hop_tpu_torch import geometry
from hop_tpu_torch.config import DataConfig
from hop_tpu_torch.data.records import RecordReader, schema_for
from hop_tpu_torch.data.vocab import Vocab


class SpeechMotionDataset:
    def __init__(self, record_path: str, cfg: DataConfig,
                 lang_model: Optional[Vocab] = None,
                 speaker_model: Optional[Vocab] = None,
                 tokenizer=None, use_native_reader: bool = True):
        self.cfg = cfg
        skel = cfg.skeleton
        self.schema = schema_for(cfg.n_poses, cfg.pose_resampling_fps,
                                 skel.n_joints, skel.n_bones, cfg.mel_bins)
        self.reader = RecordReader(record_path, self.schema,
                                   use_native=use_native_reader)
        self.lang_model = lang_model
        self.tokenizer = tokenizer
        self.expected_audio_length = cfg.expected_audio_length
        self.expected_spectrogram_length = \
            geometry.calc_spectrogram_length_from_motion_length(
                cfg.n_poses, cfg.pose_resampling_fps)
        self._aux_cache = [self.reader.aux(i) for i in range(len(self.reader))]
        if speaker_model is None:
            speaker_model = Vocab("vid", insert_default_tokens=False)
            for aux in self._aux_cache:
                speaker_model.index_word(aux["vid"])
        self.speaker_model = speaker_model

    def __len__(self):
        return len(self.reader)

    def set_lang_model(self, lang_model: Vocab):
        self.lang_model = lang_model

    # -- alignment ---------------------------------------------------------
    def _align_words(self, words, start_time, end_time):
        """Returns (extended_word_indices, text_token_padded) of length
        n_poses (lmdb_data_loader.py:129-200)."""
        cfg = self.cfg
        n_frames = cfg.n_poses
        frame_dur = (end_time - start_time) / n_frames
        word_idx = np.zeros(n_frames, np.int64)
        token_idx = np.zeros(n_frames, np.int64)

        if self.tokenizer is not None:
            text = " ".join(w[0] for w in words)
            hf_ids = self.tokenizer(text)[: cfg.max_text_tokens]
        else:
            hf_ids = None

        if cfg.remove_word_timing:
            n_words = sum(
                1 for w in words
                if max(0, int(math.floor((w[1] - start_time) / frame_dur)))
                < n_frames)
            space = int(n_frames / (n_words + 1)) if n_words else 0
            for i in range(n_words):
                idx = (i + 1) * space
                word_idx[idx] = self.lang_model.get_word_index(words[i][0])
                if hf_ids is not None and i < len(hf_ids):
                    token_idx[idx] = hf_ids[i]
        else:
            i = 0
            for w in words:
                idx = max(0, int(math.floor((w[1] - start_time) / frame_dur)))
                if idx < n_frames:
                    word_idx[idx] = self.lang_model.get_word_index(w[0])
                    if hf_ids is not None and i < len(hf_ids):
                        token_idx[idx] = hf_ids[i]
                    i += 1
        return word_idx, token_idx

    def _word_seq(self, words, end_time):
        """SOS + ids + EOS (lmdb_data_loader.py:223-230)."""
        ids = [self.lang_model.SOS_token]
        for w in words:
            if end_time is not None and w[1] > end_time:
                break
            ids.append(self.lang_model.get_word_index(w[0]))
        ids.append(self.lang_model.EOS_token)
        return np.asarray(ids, np.int64)

    # -- batching ----------------------------------------------------------
    def make_batch(self, indices: np.ndarray, max_words: int = 36) -> dict:
        """Assemble one host batch (numpy). Audio stays raw; the log-mel is
        computed on the device by the caller (`cli.common.device_batch`)."""
        cfg = self.cfg
        arrays = self.reader.gather(indices)
        n = cfg.n_poses

        vec = arrays["vec_seq"][:, :n].reshape(len(indices), n, -1)
        pose = arrays["pose_seq"][:, :n].reshape(len(indices), n, -1)

        audio = arrays["audio"]
        if audio.shape[1] >= self.expected_audio_length:
            audio = audio[:, :self.expected_audio_length]
        else:
            audio = np.pad(audio,
                           ((0, 0),
                            (0, self.expected_audio_length - audio.shape[1])),
                           mode="symmetric")
        spectrogram = arrays["spectrogram"][
            :, :, :self.expected_spectrogram_length]

        B = len(indices)
        text_padded = np.zeros((B, n), np.int64)
        text_tokens = np.zeros((B, n), np.int64)
        word_seq = np.zeros((B, max_words), np.int64)
        text_lengths = np.zeros((B,), np.int32)
        vids = np.zeros((B,), np.int32)
        for bi, idx in enumerate(indices):
            aux = self._aux_cache[int(idx)]
            words = aux["words"]
            duration = aux["end_time"] - aux["start_time"]
            frames_ext = self.schema.n_frames_ext
            # The reference clips the extended window to n_poses frames and
            # aligns words against the CLIPPED end time: extend_word_seq is
            # called with sample_end_time (lmdb_data_loader.py:206,234), so
            # frame_duration there is (sample_end_time - start_time)/n_frames
            # (:136). Passing the extended end_time would stretch every
            # word-to-frame index by n_frames_ext/n_poses (~1.24x).
            sample_end_time = aux["start_time"] + duration * n / frames_ext
            w, t = self._align_words(words, aux["start_time"],
                                     sample_end_time)
            text_padded[bi], text_tokens[bi] = w, t
            ws = self._word_seq(words, sample_end_time)[:max_words]
            word_seq[bi, :len(ws)] = ws
            text_lengths[bi] = len(ws)
            vids[bi] = self.speaker_model.word2index.get(aux["vid"], 0)

        return {
            "target_vec": vec.astype(np.float32),
            "pose_seq": pose.astype(np.float32),
            "in_audio": audio.astype(np.float32),
            "spectrogram": spectrogram.astype(np.float32),
            "text_padded": text_padded,
            "text_tokens": text_tokens,
            "word_seq": word_seq,
            "text_lengths": text_lengths,
            "vid_indices": vids,
        }

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True) -> Iterator[dict]:
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        end = (len(order) // batch_size * batch_size if drop_last
               else len(order))
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            yield self.make_batch(idx)
