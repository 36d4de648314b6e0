"""fastText ``.bin`` -> aligned word-embedding matrix, with no fasttext
package (port of hop_tpu/data/fasttext_export.py: the same parser, over
the port's record store and vocabulary; the dictionary is read from a map
of the file, where hop_tpu reads the whole file into memory).

The reference initialises every text encoder from
``crawl-300d-2M-subword.bin`` via ``fasttext.load_model(...).
get_word_vector(word)`` (model/vocab.py:70-84); the fasttext package is
not available here, so this module parses the ``.bin`` file format
directly (fastText FILEFORMAT_MAGIC 793712314, versions 11/12) and
reproduces ``get_word_vector`` exactly:

- dictionary entries (word, count, type) in id order;
- subword extraction over ``<word>`` with UTF-8 boundary handling and
  the (minn..maxn, skip-boundary-1-grams) rule of
  fasttext/src/dictionary.cc ``computeSubwords``;
- the signed-char FNV-1a hash into ``bucket`` ngram slots;
- word vector = mean of the input-matrix rows of [word id] + ngram ids
  (ngram ids offset by nwords), OOV words use ngrams only.

The input matrix is memory-mapped, so exporting from the 7 GB crawl
model needs only the touched rows.

CLI: build the (n_words, dim) matrix aligned with a vocab (built from
record stores) and save it as the ``.npy`` artifact ``Vocab.
load_word_vectors`` consumes:

  python -m hop_tpu_torch.data.fasttext_export --bin crawl-300d-2M-subword.bin \
      --records /data/records/train /data/records/val --out wordvec.npy

`cli.common.load_datasets` also takes the ``.bin`` itself as
``--wordembed-path``: each vocabulary word's vector is then read from it
(`FastTextModel.get_word_vector`) as the vocabulary is built.
"""

from __future__ import annotations

import argparse
import mmap
import pickle
import struct

import numpy as np

from hop_tpu_torch.config import expressive_config, ted_config
from hop_tpu_torch.data.records import RecordReader, schema_for
from hop_tpu_torch.data.vocab import Vocab, build_vocab

MAGIC = 793712314
EOS = "</s>"
BOW, EOW = "<", ">"


def ft_hash(data: bytes) -> int:
    """fastText's FNV-1a variant: bytes are sign-extended (dictionary.cc
    Dictionary::hash casts through int8_t)."""
    h = 2166136261
    for b in data:
        if b >= 128:
            b -= 256
        h = (h ^ (b & 0xFFFFFFFF)) * 16777619 & 0xFFFFFFFF
    return h


def compute_subwords(word: str, minn: int, maxn: int, bucket: int):
    """ngram hash ids (bucket-relative) for BOW+word+EOW, matching
    dictionary.cc computeSubwords: iterate at UTF-8 char boundaries,
    keep n in [minn, maxn], skip length-1 grams touching a boundary."""
    data = (BOW + word + EOW).encode("utf-8")
    out = []
    size = len(data)
    for i in range(size):
        if (data[i] & 0xC0) == 0x80:   # UTF-8 continuation byte
            continue
        ngram = bytearray()
        j, n = i, 1
        while j < size and n <= maxn:
            ngram.append(data[j])
            j += 1
            while j < size and (data[j] & 0xC0) == 0x80:
                ngram.append(data[j])
                j += 1
            if n >= minn and not (n == 1 and (i == 0 or j == size)):
                out.append(ft_hash(bytes(ngram)) % bucket)
            n += 1
    return out


class FastTextModel:
    """Read-only view of a (non-quantized) fastText .bin model."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic, version = struct.unpack("<ii", f.read(8))
            if magic != MAGIC:
                raise ValueError(f"{path}: not a fastText .bin model "
                                 f"(magic {magic})")
            if version > 12:
                raise ValueError(f"unsupported fastText version {version}")
            (self.dim, self.ws, self.epoch, self.min_count, self.neg,
             self.word_ngrams, self.loss, self.model_kind, self.bucket,
             self.minn, self.maxn, self.lr_update_rate) = struct.unpack(
                "<12i", f.read(48))
            (self.t,) = struct.unpack("<d", f.read(8))

            size, self.nwords, self.nlabels = struct.unpack("<iii",
                                                            f.read(12))
            self.ntokens, pruneidx_size = struct.unpack("<qq", f.read(16))
            self.words: list[str] = []
            # the rest of the dictionary, then the matrices, parsed by hand
            # from a map of the file: the matrices' pages are not read here
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            pos = f.tell()
        try:
            for _ in range(size):
                end = buf.find(b"\0", pos)
                if end < 0:
                    raise ValueError(f"{path}: dictionary ends inside a word")
                self.words.append(buf[pos:end].decode("utf-8"))
                pos = end + 1 + 8 + 1   # count int64 + type int8
            if pruneidx_size > 0:
                self.pruneidx = {}
                for _ in range(pruneidx_size):
                    a, b = struct.unpack_from("<ii", buf, pos)
                    self.pruneidx[a] = b
                    pos += 8
            else:
                self.pruneidx = None if pruneidx_size < 0 else {}
            self.pruned = pruneidx_size >= 0

            (quant_input,) = struct.unpack_from("<b", buf, pos)
            pos += 1
            if quant_input:
                raise ValueError("quantized (.ftz) models are not supported")
            m, n = struct.unpack_from("<qq", buf, pos)
            pos += 16
        finally:
            buf.close()
        if n != self.dim:
            raise ValueError(f"{path}: input matrix is {m} x {n}, the header "
                             f"says dim {self.dim}")
        self._matrix_offset = pos
        self._matrix_shape = (m, n)

        self.input = np.memmap(path, dtype=np.float32, mode="r",
                               offset=self._matrix_offset,
                               shape=self._matrix_shape)
        self.word2id = {w: i for i, w in enumerate(self.words[:self.nwords])}

    def subword_ids(self, word: str) -> list[int]:
        ids = []
        wid = self.word2id.get(word)
        if wid is not None:
            ids.append(wid)
            if word == EOS:
                return ids
        if self.maxn <= 0:
            return ids
        for h in compute_subwords(word, self.minn, self.maxn, self.bucket):
            if self.pruned:
                if self.pruneidx and h in self.pruneidx:
                    h = self.pruneidx[h]
                elif self.pruneidx is not None:
                    continue
            ids.append(self.nwords + h)
        return ids

    def get_word_vector(self, word: str) -> np.ndarray:
        ids = self.subword_ids(word)
        if not ids:
            return np.zeros(self.dim, np.float32)
        return np.asarray(self.input[ids].mean(axis=0), np.float32)


def export_embeddings(model: FastTextModel, vocab, seed: int = 0):
    """(n_words, dim) matrix aligned with ``vocab`` ids — special tokens
    keep the reference's normal(0, 1/sqrt(dim)) init (vocab.py:73-76),
    every indexed word gets its fastText vector."""
    init_sd = 1.0 / np.sqrt(model.dim)
    weights = np.random.default_rng(seed).normal(
        0, init_sd, (vocab.n_words, model.dim)).astype(np.float32)
    for word, idx in vocab.word2index.items():
        weights[idx] = model.get_word_vector(word)
    return weights


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--bin", required=True, help="fastText .bin model")
    p.add_argument("--out", required=True, help="output .npy matrix")
    p.add_argument("--records", nargs="+", default=[],
                   help="record-store prefixes whose words define the vocab")
    p.add_argument("--vocab-cache", default=None,
                   help="existing vocab pickle (build_vocab cache) to align "
                        "with instead of --records")
    p.add_argument("--dataset", default="TED",
                   choices=("TED", "TED_expressive"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.vocab_cache:
        with open(args.vocab_cache, "rb") as f:
            vocab: Vocab = pickle.load(f)
    elif args.records:
        cfg = (ted_config() if args.dataset == "TED"
               else expressive_config())
        skel = cfg.data.skeleton
        schema = schema_for(cfg.data.n_poses, cfg.data.pose_resampling_fps,
                            skel.n_joints, skel.n_bones, cfg.data.mel_bins)
        word_lists = []
        for prefix in args.records:
            reader = RecordReader(prefix, schema, use_native=False)
            word_lists.append([w for i in range(len(reader))
                               for w in reader.aux(i)["words"]])
        vocab = build_vocab("words", word_lists)
    else:
        raise SystemExit("pass --records or --vocab-cache")

    model = FastTextModel(args.bin)
    weights = export_embeddings(model, vocab, args.seed)
    np.save(args.out, weights)
    print(f"exported {weights.shape[0]} x {weights.shape[1]} embeddings "
          f"({len(vocab.word2index)} fastText words) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
