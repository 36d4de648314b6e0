"""The port's validation entry (`hop_tpu_torch.cli.test_checkpoint
--evaluate`) on the CPU at the tiny size, and its frozen FGD feature net
read from the .npz that hop_tpu's `save_arrays` writes.

With the same .npz, the port's `make_fgd_evaluator` and hop_tpu's score
the same pushed poses alike: feature distance and diversity to 1e-5
relative, FGD to 1e-3 relative (singular covariances of fewer samples than
feature dimensions: tests/test_torch_eval.py).
"""

import contextlib
import io
import math
import re
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hop_tpu import config as jcfg
from hop_tpu.cli import common as JC
from hop_tpu.data.wordpiece import build_vocab_file
from hop_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from hop_tpu.models.motion_ae import MotionAE as JaxMotionAE
from hop_tpu.utils.checkpoint import save_arrays

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.cli import common as C
from hop_tpu_torch.cli import test_checkpoint

from test_torch_fasttext import write_fasttext_bin

FGD_REL_TOL = 1e-3
REL_TOL = 1e-5
EVAL_ARGS = ["--device", "cpu", "--tiny", "--clip-seconds", "2", "--evaluate",
             "--eval-videos", "1"]
VAL = re.compile(r"\[VAL\] loss: (\S+), joint mae: (\S+), FGD: (\S+), feat_D: (\S+), "
                 r"BC: (\S+) / \S+, Diversity: (\S+)")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_checkpoint.main(argv)
    return out.getvalue()


def _val(stdout):
    m = VAL.search(stdout)
    assert m, stdout
    return [float(x) for x in m.groups()]


def _eval_net_npz(tmp_path, dataset, seed=3):
    """hop_tpu's feature net, initialised by flax, saved by save_arrays."""
    if dataset == "TED":
        net = JaxEmbeddingNet(pose_dim=27, n_frames=34, n_words=10, mode="pose")
        poses = jnp.zeros((2, 34, 27))
        variables = net.init(jax.random.PRNGKey(seed), None, None, poses[:, :4],
                             poses, input_mode="pose")
    else:
        net = JaxMotionAE(pose_dim=126, latent_dim=128)
        variables = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, 34, 126)))
    path = str(tmp_path / f"eval_net_{dataset}.npz")
    save_arrays(path, variables)
    return path


def test_entry_defaults_to_the_card():
    args = test_checkpoint.parse_args([])
    assert args.device == "cuda" and not args.evaluate and args.eval_batch_size is None
    assert args.eval_videos == 20


def test_evaluate_on_the_cpu_with_an_untrained_net():
    """--evaluate with no --eval-net: the loud warning, the marked result,
    the config's batch size (4 at the tiny size) over one 20 s clip's 26
    windows (7 batches), the native gather, finite metrics and diversity > 0
    (with hop_tpu's permutation from default_rng(0), 2 batches keep their
    order and score 0, like 1)."""
    stdout = _run(EVAL_ARGS)
    assert "generated 34 frames" in stdout
    assert "RANDOMLY INITIALISED" in stdout
    assert "[FGD/diversity from an UNTRAINED feature net]" in stdout
    assert "evaluate: 26 windows in batches of 4, native gather" in stdout
    values = _val(stdout)
    assert all(math.isfinite(v) for v in values)
    assert values[-1] > 0 and values[4] > 0


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_eval_net_npz_gives_hop_tpus_scores(tmp_path, dataset):
    path = _eval_net_npz(tmp_path, dataset)
    port = C.make_fgd_evaluator(tcfg.tiny_test_config(dataset), 10, path, device="cpu")
    ref = JC.make_fgd_evaluator(jcfg.tiny_test_config(dataset), 10, path)
    assert port.trained and ref.trained
    dim = 27 if dataset == "TED" else 126
    for seed in range(3):
        r = np.random.default_rng(seed)
        real = r.normal(size=(8, 34, dim)).astype(np.float32)
        gen = r.normal(loc=0.3, size=(8, 34, dim)).astype(np.float32)
        port.push_samples(torch.from_numpy(gen), torch.from_numpy(real))
        ref.push_samples(jnp.asarray(gen), jnp.asarray(real))
    (fd, feat), (fd_j, feat_j) = port.get_scores(), ref.get_scores()
    assert abs(fd - fd_j) <= FGD_REL_TOL * abs(fd_j)
    assert abs(feat - feat_j) <= REL_TOL * abs(feat_j)
    div, div_j = port.get_diversity_scores(), ref.get_diversity_scores()
    assert div > 0 and abs(div - div_j) <= REL_TOL * div_j


def test_evaluate_with_an_eval_net(tmp_path):
    path = _eval_net_npz(tmp_path, "TED")
    stdout = _run(EVAL_ARGS + ["--eval-net", path, "--eval-batch-size", "10"])
    assert "RANDOMLY" not in stdout and "UNTRAINED" not in stdout
    assert "evaluate: 26 windows in batches of 10" in stdout
    values = _val(stdout)
    assert all(math.isfinite(v) for v in values) and values[-1] > 0


def test_hf_token_stream_needs_a_vocab(tmp_path):
    with pytest.raises(SystemExit):
        test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                              "--use-hf-token-stream"])
    vocab = str(tmp_path / "vocab.txt")
    build_vocab_file(["[PAD]", "[UNK]", "the", "quick", "fox", "hands", "air"], vocab)
    stdout = _run(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                   "--use-hf-token-stream", "--hf-vocab", vocab])
    assert "generated 34 frames" in stdout


def _dataset_args(data="synthetic", **kw):
    import argparse
    return argparse.Namespace(data=data, synthetic_videos=2, seed=5, val_data=None,
                              wordembed_path=None, use_hf_token_stream=False,
                              hf_vocab=None, **kw)


def test_load_datasets_matches_jax(monkeypatch, tmp_path):
    """The synthetic branch (2 videos of 20 s: train both, validate on the
    first) and the record-path branch, against hop_tpu's load_datasets;
    the record-path branch also with a fastText .bin as the word vectors."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    port = C.load_datasets(tcfg.tiny_test_config(), _dataset_args())
    ref = JC.load_datasets(jcfg.tiny_test_config(), _dataset_args())
    for got, want in zip(port[:2], ref[:2]):
        assert len(got) == len(want) > 0
        assert got.speaker_model.word2index == want.speaker_model.word2index
        assert got.lang_model is port[2]
    assert port[2].word2index == ref[2].word2index
    np.testing.assert_array_equal(port[2].word_embedding_weights,
                                  ref[2].word_embedding_weights)
    train_path = str(port[0].reader.path)
    again = C.load_datasets(tcfg.tiny_test_config(), _dataset_args(train_path))
    assert len(again[0]) == len(again[1]) == len(port[0])
    args = _dataset_args(train_path)
    args.wordembed_path = str(tmp_path / "words.bin")
    write_fasttext_bin(args.wordembed_path, ["the", "fox", "people", "a", "</s>"],
                       dim=tcfg.tiny_test_config().data.wordembed_dim, bucket=100)
    port = C.load_datasets(tcfg.tiny_test_config(), args)[2]
    ref = JC.load_datasets(jcfg.tiny_test_config(), args)[2]
    assert port.word2index == ref.word2index
    np.testing.assert_array_equal(port.word_embedding_weights, ref.word_embedding_weights)


def test_make_eval_fn_runs_the_pass_per_epoch(monkeypatch, tmp_path):
    """eval_fn(state, epoch): the validation split in order at the config's
    batch size (4: 26 windows, 7 batches), BC only after epoch 35, the
    speaker ids of epoch e from a generator seeded 1234 + e."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = tcfg.tiny_test_config()
    _, val_ds, lang = C.load_datasets(cfg, _dataset_args())
    evaluator = C.make_fgd_evaluator(cfg, lang.n_words, None, device="cpu")
    seen = []

    def generate_from_state(state, batch, vids, generator):
        seen.append(vids.clone())
        return torch.tanh(batch["target_vec"] + state * vids[:, None, None])
    eval_fn = C.make_eval_fn(cfg, val_ds, evaluator, generate_from_state, 10,
                             device="cpu")
    early, late = eval_fn(0.1, 35), eval_fn(0.1, 36)
    assert early.bc == 0.0 and late.bc > 0
    assert len(seen) == 2 * -(-len(val_ds) // 4) >= 6
    for r in (early, late):
        assert all(math.isfinite(getattr(r, f)) for f in (
            "loss", "mae", "frechet_dist", "feat_dist", "diversity"))
        assert not r.eval_net_trained
    want = torch.randint(0, 10, (4,), generator=torch.Generator().manual_seed(1234 + 36))
    assert torch.equal(seen[len(seen) // 2], want)
