"""The training entry point on 2 ranks: `python -m hop_tpu_torch.cli.run_ted
--data-parallel 2` launched as torchrun launches it (one process a rank, gloo
on the CPU, one thread a rank), at the tiny size on the records of one
synthetic video, global batch 8, the GAN gate open from epoch 1, ZeRO on
(the default at data 2).

  * 2 epochs in one run, and 1 epoch then `--resume` to 2, end in
    checkpoints equal in every tensor (the optimizers' moments gathered into
    the one-process format) and in equal metrics.jsonl files;
  * rank 0 alone writes: one metrics stream, one checkpoint directory, and
    only rank 0's output holds the loop's lines;
  * the 2-rank checkpoint loads into the one-process long-form entry
    (`test_checkpoint`), which knows nothing of ranks;
  * `--model hierarchy` on a split batch is refused by name (M15b).
"""

import concurrent.futures
import contextlib
import io
import os

import pytest
import torch

from hop_tpu_torch.cli import test_checkpoint
from hop_tpu_torch.parallel.local import check_ranks, run_ranks
from hop_tpu_torch.utils.checkpoint import differing_entries

RANK_SECONDS = 300
RUN = ["-m", "hop_tpu_torch.cli.run_ted", "--device", "cpu", "--tiny",
       "--synthetic-videos", "1", "--batch-size", "8", "--warmup-epochs", "0",
       "--data-parallel", "2", "--log-every", "1"]


def _launch(tmp_path, name, *extra):
    ck = tmp_path / name
    env = {"TMPDIR": str(tmp_path), "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))}
    return ck, run_ranks(RUN + ["--checkpoint-dir", str(ck), "--metrics",
                                str(ck / "metrics.jsonl"), *extra], 2, RANK_SECONDS, env)


def _run(tmp_path, name, *extra):
    ck, results = _launch(tmp_path, name, *extra)
    check_ranks(results)
    return ck, [r.output for r in results]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-epoch run, the 1-epoch run and the hierarchy's refused run side
    by side, then the resume to 2 epochs."""
    tmp = tmp_path_factory.mktemp("runs")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        whole = pool.submit(_run, tmp, "whole", "--epochs", "2")
        first = pool.submit(_run, tmp, "resumed", "--epochs", "1")
        hierarchy = pool.submit(_launch, tmp, "hierarchy", "--model", "hierarchy",
                                "--epochs", "1")
        (whole, out), _ = whole.result(), first.result()
    resumed, out_resumed = _run(tmp, "resumed", "--epochs", "2", "--resume")
    return whole, resumed, out, out_resumed, hierarchy.result()[1]


def test_two_epochs_equal_one_and_a_resume(runs):
    whole, resumed, _, out_resumed, _ = runs
    assert "resumed from checkpoint epoch 0" in out_resumed[0]
    a = torch.load(whole / "ckpt_1.pt", weights_only=True)
    b = torch.load(resumed / "ckpt_1.pt", weights_only=True)
    assert differing_entries(a, b) == []
    assert a["gen_opt"]["state"] and a["dis_opt"]["state"]
    assert (whole / "metrics.jsonl").read_text() == (resumed / "metrics.jsonl").read_text()


def test_rank_zero_alone_writes(runs):
    whole, _, out, _, _ = runs
    assert "mesh: data=2 x model=1 (zero2 opt-state sharding)" in out[0]
    assert "[VAL]" in out[0] and "Epoch: 2" in out[0]
    assert "[VAL]" not in out[1] and "Epoch: 2" not in out[1]
    lines = (whole / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 * 4          # two epochs of four validation scalars
    assert sorted(p.name for p in whole.glob("ckpt_*.pt")) == ["ckpt_0.pt", "ckpt_1.pt"]


def test_the_two_rank_checkpoint_loads_into_one_process(runs):
    whole = runs[0]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                                    "--vid", "0", "--checkpoint-dir", str(whole)])
    assert out.shape == (34, 27)
    assert "restored checkpoint step 1" in log.getvalue()


def test_the_hierarchy_on_a_split_batch_is_refused(runs):
    """Its contrastive terms run over all pairs of the global batch: on a
    batch split over ranks it exits naming ROADMAP.md M15b, on every rank."""
    for r in runs[4]:
        assert r.returncode == 1 and "ROADMAP.md M15b" in r.output, r.output[-2000:]
