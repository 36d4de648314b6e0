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
  * `--model hierarchy` (HA2G, its full-depth ResNetSE) on a split batch,
    global batch 4 of the records of one seeded 6 s clip: 2 epochs against
    1 epoch and `--resume` to 2, bit for bit likewise, and its 2-rank
    checkpoint resumed by `run_ted` in one process (`--resume` without
    ranks) to a third epoch.
"""

import concurrent.futures
import contextlib
import io
import os
import shutil

import pytest
import torch

from hop_tpu_torch.cli import run_ted, test_checkpoint
from hop_tpu_torch.parallel.local import check_ranks, run_ranks
from hop_tpu_torch.utils.checkpoint import CheckpointManager, differing_entries

from test_torch_hierarchy_cli import clip_records

RANK_SECONDS = 300
RUN = ["-m", "hop_tpu_torch.cli.run_ted", "--device", "cpu", "--tiny",
       "--synthetic-videos", "1", "--batch-size", "8", "--warmup-epochs", "0",
       "--data-parallel", "2", "--log-every", "1"]


def _run(tmp_path, name, *extra, run=RUN):
    ck = tmp_path / name
    env = {"TMPDIR": str(tmp_path), "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))}
    results = run_ranks(run + ["--checkpoint-dir", str(ck), "--metrics",
                               str(ck / "metrics.jsonl"), *extra], 2, RANK_SECONDS, env)
    check_ranks(results)
    return ck, [r.output for r in results]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-epoch run and the 1-epoch run side by side, then the resume to 2
    epochs."""
    tmp = tmp_path_factory.mktemp("runs")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        whole = pool.submit(_run, tmp, "whole", "--epochs", "2")
        first = pool.submit(_run, tmp, "resumed", "--epochs", "1")
        (whole, out), _ = whole.result(), first.result()
    resumed, out_resumed = _run(tmp, "resumed", "--epochs", "2", "--resume")
    return whole, resumed, out, out_resumed


@pytest.fixture(scope="module")
def hierarchy_runs(tmp_path_factory, runs):
    """The hierarchy's 2-epoch and 1-epoch runs side by side, the resume to 2
    epochs, and the 2-epoch run's checkpoint resumed in this process to 3
    (on a copy, one torch thread)."""
    tmp = tmp_path_factory.mktemp("hierarchy")
    run = [*RUN, "--model", "hierarchy", "--batch-size", "4",
           *clip_records(tmp, "TED")]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        whole = pool.submit(_run, tmp, "whole", "--epochs", "2", run=run)
        first = pool.submit(_run, tmp, "resumed", "--epochs", "1", run=run)
        (whole, out), _ = whole.result(), first.result()
    resumed, out_resumed = _run(tmp, "resumed", "--epochs", "2", "--resume", run=run)
    alone = tmp / "alone"
    shutil.copytree(whole, alone)
    log, n = io.StringIO(), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(log):
            run_ted.main([*run[run.index("--device"):run.index("--data-parallel")],
                          *run[run.index("--model"):], "--checkpoint-dir", str(alone),
                          "--metrics", str(alone / "metrics.jsonl"), "--epochs", "3",
                          "--resume"])
    finally:
        torch.set_num_threads(n)
    return whole, resumed, out, out_resumed, alone, log.getvalue()


def test_two_epochs_equal_one_and_a_resume(runs):
    whole, resumed, _, out_resumed = runs
    assert "resumed from checkpoint epoch 0" in out_resumed[0]
    a = torch.load(whole / "ckpt_1.pt", weights_only=True)
    b = torch.load(resumed / "ckpt_1.pt", weights_only=True)
    assert differing_entries(a, b) == []
    assert a["gen_opt"]["state"] and a["dis_opt"]["state"]
    assert (whole / "metrics.jsonl").read_text() == (resumed / "metrics.jsonl").read_text()


def test_rank_zero_alone_writes(runs):
    whole, _, out, _ = runs
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


def test_the_hierarchy_on_a_split_batch_equals_one_epoch_and_a_resume(hierarchy_runs):
    whole, resumed, out, out_resumed, _, _ = hierarchy_runs
    assert "mesh: data=2 x model=1 (zero2 opt-state sharding)" in out[0]
    assert "[VAL]" in out[0] and "Epoch: 2" in out[0]
    assert "resumed from checkpoint epoch 0" in out_resumed[0]
    a = torch.load(whole / "ckpt_1.pt", weights_only=True)
    b = torch.load(resumed / "ckpt_1.pt", weights_only=True)
    assert differing_entries(a, b) == []
    assert a["gen_opt"]["state"] and a["dis_opt"]["state"]
    for f in ("metrics.jsonl", "best_metrics.json"):
        assert (whole / f).read_text() == (resumed / f).read_text(), f


def test_a_two_rank_hierarchy_checkpoint_resumes_in_one_process(hierarchy_runs):
    whole, _, _, _, alone, log = hierarchy_runs
    assert "resumed from checkpoint epoch 1" in log and "mesh:" not in log
    a, b = CheckpointManager(str(whole)), CheckpointManager(str(alone))
    assert (a.latest_step(), b.latest_step()) == (1, 2)
    before, after = a.restore(), b.restore()
    assert sorted(before) == sorted(after)
    assert after["step"] == before["step"] + 1
    assert differing_entries(before["gen"], after["gen"])
    assert all(torch.isfinite(v).all() for net in ("gen", "dis") for v in after[net].values()
               if v.is_floating_point())
