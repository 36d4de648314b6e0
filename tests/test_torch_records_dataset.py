"""The port's data path (hop_tpu_torch.data, .native) against hop_tpu.data on
the same seeded inputs, on the CPU: source clips, the preprocessor's
windows and records, the record store read across the two packages, the
C++ gatherer against the numpy gather, `SpeechMotionDataset` batches field
by field and through `device_batch`, the vocabulary, WordPiece and the
text helpers.

Everything is numpy on both sides, so it is held bitwise, with one
exception: the spectrogram (of a source clip, and so of a record and a
batch) comes from each package's own log-mel frontend, which agree to
~1e-3 dB (f32 round-off of the matmul DFT shows in dB): 2e-3, the
tolerance of tests/test_torch_device_batch.py. Records written from the
same clips are byte-identical.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.cli.common import device_batch as jax_device_batch
from hop_tpu.data import dataset as jds
from hop_tpu.data import preprocessor as jpre
from hop_tpu.data import records as jrec
from hop_tpu.data import synthetic as jsyn
from hop_tpu.data import text as jtext
from hop_tpu.data import vocab as jvocab
from hop_tpu.data import wordpiece as jwp

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli.common import device_batch
from hop_tpu_torch.data import dataset as tds
from hop_tpu_torch.data import preprocessor as tpre
from hop_tpu_torch.data import records as trec
from hop_tpu_torch.data import synthetic as tsyn
from hop_tpu_torch.data import text as ttext
from hop_tpu_torch.data import vocab as tvocab
from hop_tpu_torch.data import wordpiece as twp
from hop_tpu_torch.native import recordstore

MEL_TOL = 2e-3
CLIP_ARGS = dict(n_videos=3, clip_seconds=5.0, seed=3)


def _cfgs(dataset="TED", **data):
    out = []
    for mod in (tcfg, jcfg):
        cfg = mod.tiny_test_config(dataset)
        out.append(cfg.replace(data=dataclasses.replace(cfg.data, **data)))
    return out


@pytest.fixture(scope="module")
def clips():
    """{dataset: (port clips, hop_tpu clips)} from the same seed."""
    out = {}
    for dataset in ("TED", "TED_expressive"):
        tc, jc = _cfgs(dataset)
        out[dataset] = (tsyn.make_source_clips(tc, **CLIP_ARGS),
                        jsyn.make_source_clips(jc, **CLIP_ARGS))
    return out


@pytest.fixture(scope="module")
def stores(clips, tmp_path_factory):
    """TED records written by each package from its own clips."""
    tmp = tmp_path_factory.mktemp("stores")
    tc, jc = _cfgs()
    t_clips, j_clips = clips["TED"]
    n_port = tpre.DataPreprocessor(tc.data, str(tmp / "port")).run(t_clips)
    n_jax = jpre.DataPreprocessor(jc.data, str(tmp / "jax")).run(j_clips)
    assert n_port == n_jax >= 8
    return str(tmp / "port"), str(tmp / "jax")


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_source_clips_match_jax(clips, dataset):
    port, ref = clips[dataset]
    assert len(port) == len(ref)
    for (pv, pcs), (jv, jcs) in zip(port, ref):
        assert pv == jv and len(pcs) == len(jcs)
        for p, j in zip(pcs, jcs):
            for f in ("vid", "words", "start_frame_no", "end_frame_no",
                      "start_time", "end_time"):
                assert getattr(p, f) == getattr(j, f), f
            for f in ("skeletons_3d", "audio_raw"):
                np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
                assert getattr(p, f).dtype == getattr(j, f).dtype
            assert p.audio_spectrogram.shape == j.audio_spectrogram.shape
            np.testing.assert_allclose(p.audio_spectrogram, j.audio_spectrogram,
                                       rtol=0, atol=MEL_TOL)


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
@pytest.mark.parametrize("disable_filtering", [False, True])
def test_preprocessor_writes_the_same_bytes(clips, tmp_path, dataset,
                                            disable_filtering):
    """The same clips through both preprocessors: the same windows, the
    same rejections, byte-identical .bin and .idx files."""
    tc, jc = _cfgs(dataset)
    _, j_clips = clips[dataset]
    port = tpre.DataPreprocessor(tc.data, str(tmp_path / "port"),
                                 disable_filtering=disable_filtering)
    ref = jpre.DataPreprocessor(jc.data, str(tmp_path / "jax"),
                                disable_filtering=disable_filtering)
    assert port.n_poses_ext == ref.n_poses_ext == 42
    assert port.schema == trec.RecordSchema(**dataclasses.asdict(ref.schema))
    assert port.run(j_clips) == ref.run(j_clips) > 0
    assert dict(port.n_filtered) == dict(ref.n_filtered)
    for ext in (".bin", ".idx"):
        assert (tmp_path / ("port" + ext)).read_bytes() == \
            (tmp_path / ("jax" + ext)).read_bytes(), ext


def test_twenty_second_clip_gives_26_windows(tmp_path):
    """n_poses_ext = round(34 * 1.25) = 42 frames at stride 10 over a 20 s
    clip resampled to 300 frames: floor((300 - 42) / 10) + 1 = 26."""
    tc, _ = _cfgs()
    videos = tsyn.make_source_clips(tc, n_videos=1, clip_seconds=20.0, seed=0)
    pre = tpre.DataPreprocessor(tc.data, str(tmp_path / "r"), disable_filtering=True)
    assert pre.run(videos) == 26


def _random_store(path, writer_mod, n=7, seed=1):
    schema = writer_mod.schema_for(34, 15, 10, 9)
    r = np.random.default_rng(seed)
    rows = []
    with writer_mod.RecordWriter(path, schema) as w:
        for i in range(n):
            f = {name: r.normal(size=shape).astype(dt)
                 for name, shape, dt in schema.fields()}
            aux = {"vid": f"v{i % 3}", "words": [["w", 0.1 * i, 0.2 * i]],
                   "start_time": float(i), "end_time": i + 2.8,
                   "start_frame_no": i, "end_frame_no": i + 42}
            w.append(f["pose_seq"], f["vec_seq"], f["audio"], f["spectrogram"], aux)
            rows.append((f, aux))
    return schema, rows


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_read_across_packages(tmp_path, writer):
    """A store written by one package reads in the other, bitwise."""
    w_mod, r_mod = (trec, jrec) if writer == "port" else (jrec, trec)
    path = str(tmp_path / "recs")
    schema, rows = _random_store(path, w_mod)
    reader = r_mod.RecordReader(path, r_mod.schema_for(34, 15, 10, 9),
                                use_native=False)
    assert len(reader) == len(rows)
    for i, (fields, aux) in enumerate(rows):
        rec, got_aux = reader[i]
        assert got_aux == aux
        for name, want in fields.items():
            np.testing.assert_array_equal(rec[name], want, err_msg=name)
    batch = reader.gather(np.array([6, 0, 3, 3]))
    np.testing.assert_array_equal(batch["audio"][0], rows[6][0]["audio"])


def test_native_gather_matches_numpy(tmp_path):
    path = str(tmp_path / "recs")
    schema, _ = _random_store(path, trec, n=40)
    native = trec.RecordReader(path, schema, use_native=True)
    plain = trec.RecordReader(path, schema, use_native=False)
    assert native.native and not plain.native
    r = np.random.default_rng(0)
    for idx in (np.array([7, 0, 39, 3, 3]), r.integers(0, 40, size=33),
                np.arange(40)[::-1], np.array([], np.int64)):
        got, want = native.gather(idx), plain.gather(idx)
        assert set(got) == set(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for bad in (np.array([40]), np.array([-1, 2])):
        for reader in (native, plain):
            with pytest.raises(IndexError):
                reader.gather(bad)


def test_native_library_builds_outside_the_package(monkeypatch, tmp_path):
    monkeypatch.setenv("HOP_TPU_TORCH_NATIVE_DIR", str(tmp_path))
    assert recordstore.library_path().parent == tmp_path
    monkeypatch.delenv("HOP_TPU_TORCH_NATIVE_DIR")
    path = recordstore.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert recordstore.SRC.parent not in path.parents
    assert not list(recordstore.SRC.parent.glob("*.so"))
    assert recordstore.BUILD_TIMEOUT_S == 120


VOCAB_TOKENS = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                + sorted(set(jsyn._WORDS)) + ["##s", "##ing", "qu", "##ick",
                                              "la", "##zy", ",", "."])


def _tokenizers(tmp_path):
    path = str(tmp_path / "vocab.txt")
    twp.build_vocab_file(VOCAB_TOKENS, path)
    return twp.WordPieceTokenizer(path), jwp.WordPieceTokenizer(path)


def _datasets(stores, tmp_path, tokenized, **data):
    tc, jc = _cfgs(**data)
    tok_t, tok_j = _tokenizers(tmp_path) if tokenized else (None, None)
    port = tds.SpeechMotionDataset(stores[0], tc.data, tokenizer=tok_t)
    ref = jds.SpeechMotionDataset(stores[1], jc.data, tokenizer=tok_j)
    for ds, mod in ((port, tvocab), (ref, jvocab)):
        ds.set_lang_model(mod.build_vocab(
            "words", [[w for aux in ds._aux_cache for w in aux["words"]]],
            None, None, 300))
    return (tc, port), (jc, ref)


def _assert_batch_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "spectrogram":
            np.testing.assert_allclose(g, w, rtol=0, atol=MEL_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("remove_word_timing", [True, False])
@pytest.mark.parametrize("tokenized", [False, True])
def test_dataset_batches_match_jax(stores, tmp_path, remove_word_timing, tokenized):
    """Records written by each package from its own clips, batched in a
    shuffled order with a ragged tail: every field bitwise hop_tpu's but
    the spectrogram."""
    (_, port), (_, ref) = _datasets(stores, tmp_path, tokenized,
                                    remove_word_timing=remove_word_timing)
    assert len(port) == len(ref)
    assert port.speaker_model.word2index == ref.speaker_model.word2index
    assert port.expected_spectrogram_length == ref.expected_spectrogram_length
    n = 0
    for got, want in zip(port.batches(3, shuffle=True, seed=5, drop_last=False),
                         ref.batches(3, shuffle=True, seed=5, drop_last=False),
                         strict=True):
        _assert_batch_equal(got, want)
        n += 1
    assert n == -(-len(ref) // 3)
    if tokenized:
        assert (got["text_tokens"] > 0).any()


@pytest.mark.parametrize("audio_wire", ["f32", "int16"])
def test_dataset_batch_feeds_device_batch(stores, tmp_path, audio_wire):
    (tc, port), (jc, ref) = _datasets(stores, tmp_path, True, audio_wire=audio_wire)
    idx = np.array([4, 1, 0, 7])
    got = device_batch(port.make_batch(idx), tc, device="cpu")
    want = jax_device_batch(ref.make_batch(idx), jc)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if k in ("log_mel", "spectrogram"):
            np.testing.assert_allclose(g, w, rtol=0, atol=MEL_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_vocab_matches_jax(tmp_path):
    words = [("hello", 0, 1), ("world", 1, 2), ("hello", 2, 3), ("x", 3, 4)]
    port = tvocab.build_vocab("w", [words], None, None, 16)
    ref = jvocab.build_vocab("w", [words], None, None, 16)
    for attr in ("word2index", "word2count", "index2word", "n_words"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(port.word_embedding_weights,
                                  ref.word_embedding_weights)
    port.trim(2)
    ref.trim(2)
    assert port.word2index == ref.word2index
    assert port.get_word_index("missing") == ref.get_word_index("missing") == 3
    cache = str(tmp_path / "v.pkl")
    tvocab.build_vocab("w", [words], cache, None, 8)
    with open(cache, "rb") as f:
        assert pickle.load(f).word2index == \
            tvocab.build_vocab("w", [words], cache, None, 8).word2index
    old = tsyn.WordIndex(words)
    assert old.word2index == jvocab.build_vocab("w", [words], None, None, 4).word2index


CORPUS = ["Hello world, we are talking about gestures!", "the quick brown fox",
          "a lazy dog's hands?!", "Café über naïve 中国", "x" * 150, "",
          "   weird\tspacing\nhere   ", "\x00control\x7fchars�here"]


def test_wordpiece_and_text_helpers_match_jax(tmp_path):
    tok_t, tok_j = _tokenizers(tmp_path)
    for text in CORPUS:
        assert tok_t(text) == tok_j(text), text
        assert tok_t.tokenize(text) == tok_j.tokenize(text), text
        assert ttext.normalize_string(text) == jtext.normalize_string(text)
        assert ttext.remove_tags_marks(text) == jtext.remove_tags_marks(text)


def test_motion_filter_and_word_range_match_jax(clips):
    tc, jc = _cfgs()
    skel_t, skel_j = tc.data.skeleton, jc.data.skeleton
    port = tpre.MotionFilter(skel_t.mean_pose, skel_t)
    ref = jpre.MotionFilter(skel_j.mean_pose, skel_j)
    r = np.random.default_rng(0)
    frames = np.tile(skel_j.mean_pose.reshape(1, 10, 3), (42, 1, 1)).astype(np.float64)
    static = frames + 0.5
    static[:, 1] = static[:, 0] + np.array([0, -1, 0.0])
    walk = clips["TED"][1][0][1][0].skeletons_3d[:42].astype(np.float64)
    nan = walk.copy()
    nan[3, 4, 0] = np.nan
    cases = [frames, static, nan, walk] + [frames + r.normal(0, s, frames.shape)
                                           for s in (0.01, 0.05, 0.2, 0.4)]
    verdicts = [port(c) for c in cases]
    assert verdicts == [ref(c) for c in cases]
    assert {"pose", "motion", "nan", "PASS", "spine angle"} <= set(verdicts), verdicts
    words = [("a", 0.0, 1.0), ("b", 1.5, 2.0), ("c", 3.0, 4.0)]
    for t0, t1 in ((0.5, 3.0), (1.0, 1.5), (0.0, 10.0), (4.0, 5.0)):
        assert tpre.get_words_in_time_range(words, t0, t1) == \
            jpre.get_words_in_time_range(words, t0, t1)
    assert tsyn.get_words_in_time_range is tpre.get_words_in_time_range


def test_run_count_and_data_mean_match_jax(clips, tmp_path):
    tc, jc = _cfgs()
    _, j_clips = clips["TED"]
    n_port = tpre.DataPreprocessor(tc.data, str(tmp_path / "p"),
                                   disable_filtering=True).run(j_clips)
    n_ref = jpre.DataPreprocessor(jc.data, str(tmp_path / "j"),
                                  disable_filtering=True).run(j_clips)
    assert n_port == n_ref
    r = np.random.default_rng(2)
    poses = [r.normal(size=(10, 10, 3)), r.normal(size=(4, 30))]
    vecs = [r.normal(size=(10, 9, 3)), r.normal(size=(3, 27))]
    for got, want in zip(tpre.calculate_data_mean(vecs, poses, tc.data.skeleton),
                         jpre.calculate_data_mean(vecs, poses, jc.data.skeleton)):
        np.testing.assert_array_equal(got, want)
