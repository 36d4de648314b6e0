"""`python -m hop_tpu_torch.cli.test_checkpoint --data <source LMDB>
--clip-index k` on the CPU at the tiny size, on a reference-format source
LMDB of 2 seeded videos of 12 s (values written by hop_tpu's pyarrow-based
encoder): the clip it picks, its audio and words, and its seed pose (the
clip's resampled ground truth as dir-vecs minus the mean) are hop_tpu's
(hop_tpu/cli/test_checkpoint.py:70-110), the seed within 1e-6 (each
package's own f32 dir-vec arithmetic); it generates the frame count that
hop_tpu's long-form loop gives for that clip; it decodes the LMDB only up
to the clip; an index past the last clip exits with the count of clips
seen; --evaluate runs the validation pass on the videos read."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hop_tpu import config as jcfg
from hop_tpu import geometry as jgeo
from hop_tpu.data import arrow_legacy as jal
from hop_tpu.data.import_ted import iter_source_videos as jax_iter_source_videos
from hop_tpu.data.vocab import build_vocab as jax_build_vocab
from hop_tpu.infer import generate_long_form as jax_generate_long_form

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli import test_checkpoint
from hop_tpu_torch.data import import_ted
from hop_tpu_torch.data import synthetic as tsyn
from hop_tpu_torch.data.preprocessor import DataPreprocessor

from test_torch_import_ted import write_source_lmdb

SEED_TOL = 1e-6
TINY = ["--device", "cpu", "--tiny"]


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    cfg = tcfg.tiny_test_config()
    videos = tsyn.make_source_clips(cfg, n_videos=2, clip_seconds=12.0, seed=6)
    path = write_source_lmdb(str(tmp_path_factory.mktemp("src") / "lmdb_test"), videos,
                             jal.serialize)
    return cfg, path, videos


def jax_clip(path, clip_index):
    """hop_tpu's clip choice and seed pose (cli/test_checkpoint.py:79-110)."""
    cfg = jcfg.tiny_test_config()
    n_seen = 0
    for _, clips in jax_iter_source_videos(path):
        if clip_index < n_seen + len(clips):
            clip = clips[clip_index - n_seen]
            break
        n_seen += len(clips)
    skel, n_seed = cfg.data.skeleton, cfg.data.n_seed_frames
    skeletons = jgeo.resample_pose_seq(clip.skeletons_3d, clip.end_time - clip.start_time,
                                       cfg.data.pose_resampling_fps)
    seed = np.asarray(jgeo.convert_pose_seq_to_dir_vec(skeletons[:n_seed], skel)).reshape(
        n_seed, -1) - skel.mean_dir_vec
    return cfg, clip, seed


def test_data_clip_matches_hop_tpu(source, monkeypatch, capsys):
    _, path, _ = source
    seen = {}
    real = test_checkpoint.generate_long_form

    def spy(cfg, forward, audio, words, seed_vec, *args, **kw):
        seen.update(audio=audio, words=words, seed=seed_vec)
        return real(cfg, forward, audio, words, seed_vec, *args, **kw)

    monkeypatch.setattr(test_checkpoint, "generate_long_form", spy)
    out = test_checkpoint.main(TINY + ["--data", path, "--clip-index", "1"])
    jc, clip, seed = jax_clip(path, 1)
    assert f"clip 1 vid={clip.vid} (12.0s, {len(clip.words)} words)" in capsys.readouterr().out
    np.testing.assert_array_equal(seen["audio"], clip.audio_raw)
    assert [list(w) for w in seen["words"]] == [list(w) for w in clip.words]
    assert seen["seed"].shape == seed.shape
    np.testing.assert_allclose(seen["seed"], seed, rtol=0, atol=SEED_TOL)

    def stub(in_audio, log_mel, text, pre_seq, vid, rng):
        return jnp.zeros((1, jc.data.n_poses, jc.data.pose_dim))
    lang = jax_build_vocab("words", [clip.words], None, None, jc.data.wordembed_dim)
    want = jax_generate_long_form(jc, stub, clip.audio_raw, clip.words, seed, lang,
                                  vid_index=0, rng=jax.random.PRNGKey(0))
    assert out.shape == want.shape == (184, jc.data.pose_dim)
    assert np.isfinite(out).all()


def test_data_decodes_only_up_to_the_clip(source, monkeypatch):
    _, path, videos = source
    decoded = []
    real = import_ted.load_value

    def count(raw, fmt="auto"):
        decoded.append(len(raw))
        return real(raw, fmt)

    monkeypatch.setattr(import_ted, "load_value", count)
    clip, read = test_checkpoint.read_source_clip(path, 0)
    assert len(decoded) == 1 and [v for v, _ in read] == [videos[0][0]]
    assert clip.vid == videos[0][0]
    with pytest.raises(SystemExit, match=re.escape(f"--clip-index 2 out of range (2 clips in {path})")):
        test_checkpoint.main(TINY + ["--data", path, "--clip-index", "2"])
    assert len(decoded) == 3


def test_data_evaluate_runs_on_the_videos_read(source, tmp_path, capsys):
    cfg, path, videos = source
    n_windows = DataPreprocessor(cfg.data, str(tmp_path / "first")).run(videos[:1])
    out = test_checkpoint.main(TINY + ["--data", path, "--clip-index", "0", "--evaluate",
                                       "--eval-batch-size", "8"])
    stdout = capsys.readouterr().out
    assert f"evaluate: {n_windows} windows in batches of 8" in stdout
    assert "[VAL] loss:" in stdout and out.shape == (184, cfg.data.pose_dim)
