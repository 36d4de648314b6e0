"""Pure-Python WordPiece tokenizer (the reference's HF token stream; port
of hop_tpu/data/wordpiece.py).

The reference tokenizes every sample's transcript with an HF
``BertTokenizer`` (``self.tokenizer(text, ..., add_special_tokens=False)``,
lmdb_data_loader.py:155,174-199; the tokenizer itself is built in
run_ted.py:176-212). This module reproduces that tokenizer's behaviour
from a ``vocab.txt`` artifact with no transformers dependency at data-load
time: Bert "basic" tokenization (unicode cleanup, CJK isolation,
lowercasing + accent stripping, punctuation splitting) followed by greedy
longest-match-first WordPiece with ``##`` continuation pieces.

hop_tpu's copy is golden-tested token for token against
``transformers.BertTokenizer`` (tests/test_wordpiece.py); this one is held
to hop_tpu's (tests/test_torch_records_dataset.py).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Union

UNK = "[UNK]"
MAX_WORD_CHARS = 100  # words longer than this become [UNK] wholesale


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False  # treated as whitespace, not control
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation even where unicode
    # disagrees (e.g. "$", "^", "`") — matches Bert's convention
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt (one token per line, id = line number)."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token and token not in vocab:
                vocab[token] = i
    return vocab


class WordPieceTokenizer:
    """``tokenizer(text) -> List[int]`` as the dataset consumes it.

    Parameters mirror BertTokenizer's defaults for bert-base-uncased:
    lowercase + accent stripping on, CJK isolation on.
    """

    def __init__(self, vocab: Union[str, Dict[str, int]],
                 lower_case: bool = True, unk_token: str = UNK):
        self.vocab = load_vocab(vocab) if isinstance(vocab, str) else dict(vocab)
        if unk_token not in self.vocab:
            raise ValueError(f"vocab has no {unk_token!r} token")
        self.lower_case = lower_case
        self.unk_token = unk_token
        self.unk_id = self.vocab[unk_token]

    # -- basic tokenization ------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _pad_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    def _split_punct(self, token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._pad_cjk(self._clean(text))
        tokens: List[str] = []
        for tok in text.split():
            if self.lower_case:
                tok = tok.lower()
                tok = "".join(ch for ch in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(ch) != "Mn")
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    # -- wordpiece ---------------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_WORD_CHARS:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                cand = word[start:end]
                if start > 0:
                    cand = "##" + cand
                if cand in self.vocab:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]  # any unmatchable span kills the word
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def __call__(self, text: str) -> List[int]:
        return [self.vocab[t] for t in self.tokenize(text)]


def build_vocab_file(tokens: Iterable[str], path: str) -> None:
    """Write a vocab.txt (test/fixture helper)."""
    with open(path, "w", encoding="utf-8") as f:
        for t in tokens:
            f.write(t + "\n")
