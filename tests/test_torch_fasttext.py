"""The port's fastText .bin reader (hop_tpu_torch.data.fasttext_export)
against hop_tpu's, on a .bin fabricated here in the v11/v12 file format:
word vectors for in-vocabulary words, out-of-vocabulary words (subwords
alone), </s> (no subwords) and words with multi-byte UTF-8 characters,
with and without a pruned-bucket map; `export_embeddings` and the CLI over
record stores; and `cli.common.load_datasets` with a .bin as
--wordembed-path against the same run with the .npy the CLI exported.
Both packages average the same float32 rows in numpy: held equal."""

import argparse
import struct
import tempfile

import numpy as np
import pytest

from hop_tpu.data import fasttext_export as jft
from hop_tpu.data import vocab as jvocab

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli import common as C
from hop_tpu_torch.data import fasttext_export as tft
from hop_tpu_torch.data import synthetic as tsyn
from hop_tpu_torch.data import vocab as tvocab
from hop_tpu_torch.data.preprocessor import DataPreprocessor

WORDS = ["the", "gesture", "speech", "naïve", "</s>"]
PROBES = ["the", "gesture", "naïve", "</s>", "zzzqqq", "日本語", "wave", "a", ""]


def write_fasttext_bin(path, words, dim, bucket, minn=3, maxn=6, version=12,
                       pruneidx=None, seed=0):
    """A fastText model in the .bin file format, packed independently of
    the modules under test (fasttext FastText::saveModel: magic, version,
    args, dictionary, prune map, quant flag, input matrix, output matrix).
    Returns the input matrix, (len(words) + bucket, dim) f32."""
    rng = np.random.default_rng(seed)
    nwords = len(words)
    mat = rng.standard_normal((nwords + bucket, dim)).astype(np.float32)
    out = bytearray()
    out += struct.pack("<ii", 793712314, version)
    #                 dim ws epoch minCount neg wordNgrams loss model
    out += struct.pack("<12i", dim, 5, 5, 5, 5, 1, 1, 2,
                       bucket, minn, maxn, 100)          # bucket minn maxn lrUpdateRate
    out += struct.pack("<d", 1e-4)
    out += struct.pack("<iii", nwords, nwords, 0)        # size nwords nlabels
    out += struct.pack("<qq", 12345, -1 if pruneidx is None else len(pruneidx))
    for w in words:
        out += w.encode("utf-8") + b"\0" + struct.pack("<qb", 7, 0)   # count, type word
    for a, b in (pruneidx or {}).items():
        out += struct.pack("<ii", a, b)
    out += struct.pack("<b", 0)                          # quant_input false
    out += struct.pack("<qq", *mat.shape) + mat.tobytes()
    out += struct.pack("<b", 0)                          # qout false
    out += struct.pack("<qq", nwords, dim) + np.zeros((nwords, dim), np.float32).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))
    return mat


MODELS = {"v12": dict(version=12), "v11": dict(version=11),
          "pruned": dict(pruneidx={h: k for k, h in enumerate(range(0, 500, 3))}),
          "no_subwords": dict(maxn=0)}


@pytest.mark.parametrize("name", list(MODELS))
def test_word_vectors_match_hop_tpu(tmp_path, name):
    path = str(tmp_path / "m.bin")
    mat = write_fasttext_bin(path, WORDS, dim=16, bucket=500, **MODELS[name])
    port, ref = tft.FastTextModel(path), jft.FastTextModel(path)
    for attr in ("dim", "bucket", "minn", "maxn", "nwords", "words", "pruned",
                 "pruneidx", "_matrix_offset", "_matrix_shape"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(port.input, mat)
    for word in PROBES:
        assert port.subword_ids(word) == ref.subword_ids(word), word
        np.testing.assert_array_equal(port.get_word_vector(word), ref.get_word_vector(word))
    if name == "v12":      # the rule itself: the word's row and its n-grams' rows, averaged
        ids = [port.word2id["gesture"]] + [len(WORDS) + h for h in
                                           tft.compute_subwords("gesture", 3, 6, 500)]
        np.testing.assert_allclose(port.get_word_vector("gesture"), mat[ids].mean(0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(port.get_word_vector("</s>"),
                                      mat[port.word2id["</s>"]])


def test_hash_and_subwords_match_hop_tpu():
    for word in PROBES + ["é", "ab", "x" * 40]:
        data = word.encode("utf-8")
        assert tft.ft_hash(data) == jft.ft_hash(data)
        for minn, maxn in ((3, 6), (1, 3), (2, 2)):
            assert (tft.compute_subwords(word, minn, maxn, 2 ** 21)
                    == jft.compute_subwords(word, minn, maxn, 2 ** 21))


def test_a_file_that_is_not_a_model_is_refused(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(struct.pack("<ii", 1234, 12) + bytes(100))
    with pytest.raises(ValueError, match="not a fastText"):
        tft.FastTextModel(str(path))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Train and val record stores of the tiny TED config, and a .bin of
    their width (300) over some of their words."""
    root = tmp_path_factory.mktemp("ft")
    cfg = tcfg.tiny_test_config()
    videos = tsyn.make_source_clips(cfg, n_videos=2, clip_seconds=6.0, seed=4)
    for split, vids in (("train", videos), ("val", videos[:1])):
        DataPreprocessor(cfg.data, str(root / split)).run(vids)
    path = str(root / "words.bin")
    write_fasttext_bin(path, ["the", "quick", "fox", "people", "air", "a", "</s>"],
                       dim=cfg.data.wordembed_dim, bucket=200, seed=1)
    return cfg, str(root / "train"), str(root / "val"), path


def test_export_and_cli_match_hop_tpu(records, tmp_path):
    cfg, train, val, path = records
    words = ["fox", "hands", "naïve", "the"]
    port_vocab, ref_vocab = tvocab.Vocab("t"), jvocab.Vocab("t")
    for w in words:
        port_vocab.index_word(w)
        ref_vocab.index_word(w)
    got = tft.export_embeddings(tft.FastTextModel(path), port_vocab, seed=3)
    np.testing.assert_array_equal(got, jft.export_embeddings(jft.FastTextModel(path),
                                                             ref_vocab, seed=3))
    outs = {}
    for name, module in (("port", tft), ("ref", jft)):
        outs[name] = str(tmp_path / f"{name}.npy")
        assert module.main(["--bin", path, "--records", train, val,
                            "--out", outs[name]]) == 0
    np.testing.assert_array_equal(np.load(outs["port"]), np.load(outs["ref"]))


def test_load_datasets_takes_a_bin(records, tmp_path, monkeypatch):
    """--wordembed-path <.bin> gives the vocabulary matrix that the .npy the
    CLI exported from the same records gives."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg, train, val, path = records
    npy = str(tmp_path / "w.npy")
    assert tft.main(["--bin", path, "--records", train, val, "--out", npy]) == 0

    def args(source):
        return argparse.Namespace(data=train, val_data=val, synthetic_videos=1, seed=0,
                                  wordembed_path=source, use_hf_token_stream=False,
                                  hf_vocab=None)
    from_bin = C.load_datasets(cfg, args(path))[2]
    from_npy = C.load_datasets(cfg, args(npy))[2]
    assert from_bin.word2index == from_npy.word2index
    np.testing.assert_array_equal(from_bin.word_embedding_weights,
                                  from_npy.word_embedding_weights)
    model = tft.FastTextModel(path)
    known = [w for w in from_bin.word2index if w in model.word2id]
    assert known
    for w in known:
        np.testing.assert_array_equal(from_bin.word_embedding_weights[from_bin.word2index[w]],
                                      model.get_word_vector(w))
