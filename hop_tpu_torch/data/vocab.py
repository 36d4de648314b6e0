"""Word vocabulary with special tokens and pretrained-embedding attachment
(port of hop_tpu/data/vocab.py, pure Python and numpy).

Counterpart of reference model/vocab.py:8-130 and utils/vocab_utils.py:11-57.
fasttext itself is not a dependency here: `load_word_vectors` accepts any
(n_words, dim) matrix source — a precomputed .npy export of the fasttext
table, or a deterministic random fallback (the reference falls back to
random-normal init for words missing from fasttext too, vocab.py:108-128).
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np


class Vocab:
    PAD_token = 0
    SOS_token = 1
    EOS_token = 2
    UNK_token = 3

    def __init__(self, name: str, insert_default_tokens: bool = True):
        self.name = name
        self._insert_default_tokens = insert_default_tokens
        self.reset_dictionary()
        self.word_embedding_weights = None

    def reset_dictionary(self):
        self.word2index = {}
        self.word2count = {}
        if self._insert_default_tokens:
            self.index2word = {self.PAD_token: "<PAD>", self.SOS_token: "<SOS>",
                               self.EOS_token: "<EOS>", self.UNK_token: "<UNK>"}
        else:
            self.index2word = {self.UNK_token: "<UNK>"}
        self.n_words = len(self.index2word)

    def index_word(self, word: str):
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def add_vocab(self, words: Iterable[str]):
        for w in words:
            self.index_word(w)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, self.UNK_token)

    def trim(self, min_count: int):
        keep = [w for w, c in self.word2count.items() if c >= min_count]
        logging.info("vocab trim: keep %d / %d", len(keep),
                     len(self.word2index))
        self.reset_dictionary()
        for w in keep:
            self.index_word(w)

    def load_word_vectors(self, source, embedding_dim: int = 300,
                          seed: int = 0):
        """Attach (n_words, dim) weights.

        source: None (random init), a path to a .npy word-vector matrix
        aligned with this vocab, or a callable word -> vector.
        """
        # reference init_sd = 1/sqrt(dim) for special/missing rows
        # (vocab.py:73-76)
        weights = np.random.default_rng(seed).normal(
            0, 1.0 / np.sqrt(embedding_dim),
            (self.n_words, embedding_dim)).astype(np.float32)
        if source is None:
            pass
        elif callable(source):
            for w, i in self.word2index.items():
                vec = source(w)
                if vec is not None:
                    weights[i] = vec
        elif str(source).endswith((".txt", ".vec")):
            # GloVe/word2vec text format (reference vocab.py:86-130
            # __get_embedding_weight): "<word> <v0> <v1> ..." per line,
            # rows matched into this vocab, bad lines skipped
            n_found = 0
            with open(source, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip().split(" ")
                    if len(parts) != embedding_dim + 1:
                        continue
                    idx = self.word2index.get(parts[0])
                    if idx is None:
                        continue
                    try:
                        weights[idx] = np.asarray(parts[1:], np.float32)
                        n_found += 1
                    except ValueError:
                        continue
            logging.info("%d / %d word vectors found in %s", n_found,
                         len(self.word2index), source)
        else:
            mat = np.load(source)
            assert mat.shape == (self.n_words, embedding_dim), mat.shape
            weights = mat.astype(np.float32)
        self.word_embedding_weights = weights
        return weights


def build_vocab(name: str, word_lists: Sequence[Iterable[Sequence]],
                cache_path: Optional[str] = None,
                word_vec_source=None, embedding_dim: int = 300) -> Vocab:
    """Index every word seen in the given datasets' word streams.

    Counterpart of utils/vocab_utils.py:11-57: iterates (word, start, end)
    tuples, caches the result with pickle.
    """
    if cache_path and Path(cache_path).exists():
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    vocab = Vocab(name)
    for words in word_lists:
        for w in words:
            token = w[0] if isinstance(w, (tuple, list)) else w
            vocab.index_word(token)
    vocab.load_word_vectors(word_vec_source, embedding_dim)

    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump(vocab, f)
    return vocab
