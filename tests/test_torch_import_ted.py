"""The port's importer of the reference's TED / TED-Expressive LMDBs
(hop_tpu_torch.data.import_ted) against hop_tpu's, on the CPU, on
reference-format fixtures: LMDB environments (`lmdbfile.write_lmdb`) whose
values are legacy ``pyarrow.serialize`` payloads, written by hop_tpu's
pyarrow-based encoder and by the port's own, from 2 seeded videos of 12 s.

- A source LMDB imported by the port equals hop_tpu's import of it field by
  field at the tolerances of tests/test_torch_records_dataset.py (bitwise,
  the spectrogram to 2e-3 dB), for TED and for Expressive, and equals byte
  for byte the records the port's DataPreprocessor writes straight from
  the same clips.
- A cache LMDB (one window a value) imports back to those records byte for
  byte, in both packages.
- --truncate-videos-frac 0.5 keeps hop_tpu's window count.
- --dry-import's summaries and pointed messages equal hop_tpu's.
- --verify passes on the fixture (bitwise: its spectrograms came from the
  port's own log-mel), catches a planted bad filterbank or dir-vec, runs
  its matmuls with TF32 off and restores the setting, and does not move to
  the CPU when --device cuda finds no card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hop_tpu.data import arrow_legacy as jal
from hop_tpu.data import import_ted as jimp

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.data import arrow_legacy as tal
from hop_tpu_torch.data import import_ted as timp
from hop_tpu_torch.data import synthetic as tsyn
from hop_tpu_torch.data.lmdbfile import LmdbReader, write_lmdb
from hop_tpu_torch.data.preprocessor import DataPreprocessor
from hop_tpu_torch.data.records import RecordReader, schema_for

MEL_TOL = 2e-3
CLIPS = dict(n_videos=2, clip_seconds=12.0, seed=0)
SERIALIZE = {"hop_tpu": jal.serialize, "port": tal.serialize}
CONFIGS = {"TED": tcfg.ted_config, "TED_expressive": tcfg.expressive_config}


def source_value(vid, clips):
    """A source-LMDB value (reference data_preprocessor.py:46-80)."""
    return {"vid": vid, "clips": [{
        "skeletons_3d": np.asarray(c.skeletons_3d),
        "audio_raw": np.asarray(c.audio_raw),
        "audio_feat": np.asarray(c.audio_spectrogram),
        "words": [list(w) for w in c.words],
        "start_frame_no": c.start_frame_no, "end_frame_no": c.end_frame_no,
        "start_time": c.start_time, "end_time": c.end_time} for c in clips]}


def write_source_lmdb(path, videos, serialize=tal.serialize, mutate=None):
    items = {}
    for i, (vid, clips) in enumerate(videos):
        value = source_value(vid, clips)
        if mutate is not None:
            mutate(value)
        items[b"%010d" % i] = serialize(value)
    write_lmdb(path, items)
    return path


def _schema(cfg):
    skel = cfg.data.skeleton
    return schema_for(cfg.data.n_poses, cfg.data.pose_resampling_fps, skel.n_joints,
                      skel.n_bones, cfg.data.mel_bins)


def write_cache_lmdb(path, cfg, records, serialize=tal.serialize, mutate=None):
    """A cache LMDB (data_preprocessor.py:168-172) of the windows of a
    record store."""
    schema = _schema(cfg)
    reader = RecordReader(records, schema, use_native=False)
    items = {}
    for i in range(len(reader)):
        rec, aux = reader[i]
        value = [[list(w) for w in aux["words"]],
                 np.asarray(rec["pose_seq"]),
                 np.asarray(rec["vec_seq"]).reshape(schema.n_frames_ext, -1),
                 np.asarray(rec["audio"]),
                 np.asarray(rec["spectrogram"]),
                 {"vid": aux["vid"], "start_frame_no": aux["start_frame_no"],
                  "end_frame_no": aux["end_frame_no"], "start_time": aux["start_time"],
                  "end_time": aux["end_time"], "is_correct_motion": True,
                  "filtering_message": "PASS"}]
        if mutate is not None:
            mutate(i, value)
        items[b"%010d" % i] = serialize(value)
    write_lmdb(path, items)
    return path


def _read_bytes(prefix):
    return {ext: open(prefix + ext, "rb").read() for ext in (".bin", ".idx")}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{dataset: (cfg, source LMDB by writer, the direct records)}"""
    root = tmp_path_factory.mktemp("import")
    out = {}
    for dataset, make_cfg in CONFIGS.items():
        cfg = make_cfg()
        videos = tsyn.make_source_clips(cfg, **CLIPS)
        paths = {w: write_source_lmdb(str(root / f"{dataset}_{w}"), videos, ser)
                 for w, ser in SERIALIZE.items()}
        direct = str(root / f"{dataset}_direct")
        DataPreprocessor(cfg.data, direct).run(videos)
        out[dataset] = (cfg, paths, direct)
    return out


@pytest.mark.parametrize("dataset", list(CONFIGS))
def test_import_source_matches_hop_tpu(sources, tmp_path, dataset):
    cfg, paths, _ = sources[dataset]
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert timp.main(["--src", paths["hop_tpu"], "--out", port, "--dataset", dataset]) == 0
    assert jimp.main(["--src", paths["hop_tpu"], "--out", ref, "--dataset", dataset]) == 0
    got = RecordReader(port, _schema(cfg), use_native=False)
    want = RecordReader(ref, _schema(cfg), use_native=False)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        (g, g_aux), (w, w_aux) = got[i], want[i]
        for field in ("pose_seq", "vec_seq", "audio"):
            np.testing.assert_array_equal(g[field], w[field], err_msg=field)
        np.testing.assert_allclose(g["spectrogram"], w["spectrogram"], rtol=0, atol=MEL_TOL)
        assert g_aux == w_aux


@pytest.mark.parametrize("writer", list(SERIALIZE))
@pytest.mark.parametrize("dataset", list(CONFIGS))
def test_import_source_equals_the_direct_records(sources, tmp_path, dataset, writer):
    _, paths, direct = sources[dataset]
    out = str(tmp_path / "imported")
    assert timp.main(["--src", paths[writer], "--out", out, "--dataset", dataset]) == 0
    assert _read_bytes(out) == _read_bytes(direct)


@pytest.mark.parametrize("writer", list(SERIALIZE))
def test_import_cache_round_trip(sources, tmp_path, writer):
    cfg, _, direct = sources["TED"]
    cache = write_cache_lmdb(str(tmp_path / "cache"), cfg, direct, SERIALIZE[writer])
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    for main, out in ((timp.main, port), (jimp.main, ref)):
        assert main(["--src", cache, "--out", out, "--src-kind", "cache"]) == 0
    assert _read_bytes(port) == _read_bytes(direct) == _read_bytes(ref)


def test_truncate_videos_frac_matches_hop_tpu(tmp_path):
    """Of 4 videos at 0.5 the reference's loop keeps 3: it checks the count
    after a video's clips (data_preprocessor.py:50-57)."""
    cfg = tcfg.ted_config()
    videos = tsyn.make_source_clips(cfg, n_videos=4, clip_seconds=4.0, seed=2)
    src = write_source_lmdb(str(tmp_path / "src"), videos)
    counts = {}
    for name, main in (("port", timp.main), ("ref", jimp.main)):
        for frac in ("1.0", "0.5"):
            out = str(tmp_path / f"{name}{frac}")
            assert main(["--src", src, "--out", out, "--truncate-videos-frac", frac]) == 0
            counts[name, frac] = len(RecordReader(out, _schema(cfg), use_native=False))
    three = str(tmp_path / "three")
    n_three = DataPreprocessor(cfg.data, three).run(videos[:3])
    assert counts["port", "0.5"] == counts["ref", "0.5"] == n_three < counts["port", "1.0"]
    assert counts["port", "1.0"] == counts["ref", "1.0"]
    half = DataPreprocessor(dataclasses.replace(cfg.data, truncate_videos_frac=0.5),
                            str(tmp_path / "listed"))
    assert half.run(iter(videos)) == n_three          # counted by listing them


def test_dry_import_matches_hop_tpu(sources, tmp_path, capsys):
    cfg, paths, direct = sources["TED"]
    src = paths["port"]
    assert timp.main(["--src", src, "--dry-import"]) == 0
    out = capsys.readouterr().out
    assert "dry-import ok" in out and "entries=2" in out
    assert timp.dry_import(src, "source", cfg.data) == jimp.dry_import(src, "source", cfg.data)
    cache = write_cache_lmdb(str(tmp_path / "cache"), cfg, direct)
    summary = timp.dry_import(cache, "cache", cfg.data)
    assert summary == jimp.dry_import(cache, "cache", cfg.data)
    assert summary["n_frames"] == _schema(cfg).n_frames_ext
    wrong = [(src, "source", tcfg.expressive_config().data, "joints"),   # wrong preset
             (src, "cache", cfg.data, "SOURCE"),                          # wrong kind
             (cache, "source", cfg.data, "CACHE")]
    for path, kind, data_cfg, match in wrong:
        for module in (timp, jimp):
            with pytest.raises(ValueError, match=match):
                module.dry_import(path, kind, data_cfg)
    empty = str(tmp_path / "empty")
    write_lmdb(empty, {})
    with pytest.raises(ValueError, match="no entries"):
        timp.dry_import(empty, "source", cfg.data)


def test_verify_source(sources, tmp_path, capsys):
    """Bitwise on the fixture; a 1 dB error planted in a filterbank band
    fails it; a float16 artifact passes at the default tolerance."""
    cfg, paths, direct = sources["TED"]
    out = str(tmp_path / "verified")
    assert timp.main(["--src", paths["port"], "--out", out, "--verify", "--device", "cpu",
                      "--verify-tol-db", "0"]) == 0
    stdout = capsys.readouterr().out
    assert "verify ok" in stdout and "max|Δ| 0.000e+00 dB" in stdout
    assert _read_bytes(out) == _read_bytes(direct)

    videos = list(timp.iter_source_videos(paths["port"]))

    def bad_band(value):
        for c in value["clips"]:
            c["audio_feat"] = np.array(c["audio_feat"])
            c["audio_feat"][13, 5:9] += 1.0

    bad = write_source_lmdb(str(tmp_path / "bad"), videos, mutate=bad_band)
    with pytest.raises(ValueError, match="deviates .* dB"):
        timp.main(["--src", bad, "--out", str(tmp_path / "o"), "--verify", "--device", "cpu"])
    assert timp.main(["--src", bad, "--out", str(tmp_path / "o2"), "--verify",
                      "--device", "cpu", "--verify-tol-db", "1.5"]) == 0

    def half(value):
        for c in value["clips"]:
            c["audio_feat"] = np.asarray(c["audio_feat"]).astype(np.float16)

    f16 = write_source_lmdb(str(tmp_path / "f16"), videos, mutate=half)
    assert timp.main(["--src", f16, "--out", str(tmp_path / "o3"), "--verify",
                      "--device", "cpu"]) == 0


def test_verify_cache_dir_vec(sources, tmp_path, capsys):
    cfg, _, direct = sources["TED"]
    good = write_cache_lmdb(str(tmp_path / "good"), cfg, direct)
    assert timp.main(["--src", good, "--out", str(tmp_path / "o"), "--src-kind", "cache",
                      "--verify", "--verify-tol-vec", "0"]) == 0
    stdout = capsys.readouterr().out
    assert "verify ok" in stdout and "dir-vec" in stdout and "max|Δ| 0.000e+00" in stdout

    def corrupt(i, value):
        if i == 1:
            value[2] = np.array(value[2])
            value[2][3, 7] += 0.01

    bad = write_cache_lmdb(str(tmp_path / "bad"), cfg, direct, mutate=corrupt)
    with pytest.raises(ValueError, match="dir-vec deviates"):
        timp.main(["--src", bad, "--out", str(tmp_path / "o2"), "--src-kind", "cache",
                   "--verify"])


def test_verify_runs_its_matmuls_without_tf32_and_restores_the_setting(monkeypatch):
    cfg = tcfg.ted_config()
    clip = tsyn.make_source_clips(cfg, n_videos=1, clip_seconds=3.0)[0][1][0]
    seen = []
    real = timp.mel_ops.extract_melspectrogram

    def spy(audio):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(audio)

    monkeypatch.setattr(timp.mel_ops, "extract_melspectrogram", spy)
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        timp.verify_clip_mel(clip, timp.VerifyReport(0.0, 0.0), "cpu")
        assert seen == [False] and matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = before


def test_verify_on_cuda_does_not_move_to_the_cpu(sources, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the check is that a machine without one fails")
    _, paths, _ = sources["TED"]
    with pytest.raises((AssertionError, RuntimeError)):
        timp.main(["--src", paths["port"], "--out", str(tmp_path / "o"), "--verify"])


def test_lmdb_reader_closes(sources):
    _, paths, _ = sources["TED"]
    with LmdbReader(paths["port"]) as reader:
        assert len(reader) == 2
    assert reader.buf.closed
