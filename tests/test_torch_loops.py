"""The port's epoch loop (hop_tpu_torch.train.loops) against hop_tpu's
(hop_tpu.train.loops), driven with the same fake steps, scripted
validation results and fake checkpoint manager, as tests/test_loops.py
drives hop_tpu's: which step variant runs in which epoch and step, which
epochs save and with what metadata, which are recorded as best, the JSONL
lines and the best FGD returned are equal.

One difference is deliberate (ROADMAP.md Queue 3, ADVICE r5): hop_tpu
appends the diversity of a REFUSED degenerate epoch to the guard's history
(loops.py:270), so a sustained degenerate regime raises the median until
it passes; the port keeps refused epochs out and refuses on. The port's
saves also carry that history (`div_history`) for an exact resume.

Then the port's `prefetch_iter` on the four cases of tests/test_prefetch.py,
a prefetched run equal to the synchronous one, and the metrics fetched from
the device once per `log_every` steps.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu.eval.evaluate import EvalResult as JaxEvalResult
from hop_tpu.train import loops as jloops

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.eval.evaluate import EvalResult
from hop_tpu_torch.train import loops
from hop_tpu_torch.train.loops import prefetch_iter, run_training


class FakeState:
    """A train state the port's loop can save: a step count."""

    def __init__(self, n=0):
        self.n = n

    def state_dict(self):
        return {"n": self.n}


class FakeStep:
    """A step with epoch variants that records (name, variant) per call."""

    def __init__(self, name, calls, metrics, port):
        self.name, self.calls, self.metrics, self.port = name, calls, metrics, port

    def for_epoch(self, epoch):
        variant = "epoch0" if epoch == 0 else "steady"

        def step(state, batch, rng):
            self.calls.append((self.name, variant))
            if self.port:
                return FakeState(state.n + 1), {k: torch.tensor(v) for k, v in self.metrics.items()}
            return state + 1, {k: jnp.asarray(v) for k, v in self.metrics.items()}
        return step


class FakeCkpt:
    def __init__(self):
        self.saved, self.bests = [], []

    metadata = None

    def save(self, step, state, metadata=None):
        self.saved.append((step, dict(metadata)))

    def record_best(self, name, value, step):
        self.bests.append((step, value))
        return True


def _drive(port, tmp_path, fgds, divs, warmup_epochs, fused=True, n_batches=3,
           log_every=2, with_gan=True, start_epoch=0, div_history=None,
           best_fgd=float("inf")):
    """One package's run_training over scripted results; returns what it did."""
    m = tcfg if port else jcfg
    cfg = m.tiny_test_config("TED")
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, warmup_epochs=warmup_epochs),
                      hop=dataclasses.replace(cfg.hop, fused_step=fused))
    calls, ckpt = [], FakeCkpt()
    warmup = FakeStep("warmup", calls, {"loss": 1.0}, port)
    gan = FakeStep("gan", calls, {"loss": 0.5, "dis": 0.1}, port) if with_gan else None
    results = iter(list(zip(fgds, divs))[start_epoch:])
    Result = EvalResult if port else JaxEvalResult

    def eval_fn(state, epoch):
        fgd, div = next(results)
        return Result(loss=1.0, mae=0.1, frechet_dist=fgd, feat_dist=0.2, bc=0.0,
                      diversity=div, elapsed_sec=0.0)

    def batches(epoch):
        for _ in range(n_batches):
            yield ({"x": torch.zeros(4, 2)} if port else {"x": jnp.zeros((4, 2))})
    path = tmp_path / f"{'port' if port else 'jax'}_{start_epoch}.jsonl"
    kw = dict(eval_fn=eval_fn, checkpoint_manager=ckpt, metric_path=str(path),
              log_every=log_every, epochs=len(fgds), start_epoch=start_epoch)
    if port:
        state, best = run_training(cfg, batches, warmup, gan, FakeState(),
                                   rng=lambda epoch, i: None, div_history=div_history,
                                   best_fgd=best_fgd, **kw)
        n = state.n
    else:
        state, best = jloops.run_training(cfg, batches, warmup, gan, jnp.asarray(0),
                                          rng=jax.random.PRNGKey(0), **kw)
        n = int(state)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return dict(calls=calls, n=n, best=best, saved=ckpt.saved, bests=ckpt.bests,
                lines=lines)


def _assert_same(port, ref):
    assert port["calls"] == ref["calls"]
    assert port["n"] == ref["n"]
    assert port["best"] == ref["best"]
    assert port["bests"] == ref["bests"]
    assert port["lines"] == ref["lines"]
    assert [s for s, _ in port["saved"]] == [s for s, _ in ref["saved"]]
    for (_, got), (_, want) in zip(port["saved"], ref["saved"]):
        history = got.pop("div_history")
        assert all(isinstance(d, float) for d in history)
        assert got == want


def test_gating_variants_and_checkpointing_match_jax(tmp_path):
    """tests/test_loops.py's run: warmup_epochs=1, so epochs 0 and 1 run the
    warmup step (epoch 0 its epoch-0 variant) and epoch 2 the GAN step; 3
    batches an epoch; every epoch saves; the best FGD is 3."""
    args = ([5.0, 3.0, 4.0], [1.0, 1.0, 1.0], 1)
    port, ref = _drive(True, tmp_path, *args), _drive(False, tmp_path, *args)
    _assert_same(port, ref)
    assert port["calls"] == ([("warmup", "epoch0")] * 3 + [("warmup", "steady")] * 3
                             + [("gan", "steady")] * 3)
    assert port["n"] == 9 and port["best"] == 3.0 and len(port["saved"]) == 3
    assert {"val_frechet_dist/val", "BC/val", "diversity_score/val", "loss/val"} == {
        line["name"] for line in port["lines"]}


# tests/test_loops.py:107-140: (FGDs, diversities, fused step)
GUARD_CASES = {
    "refuses_degenerate_minimum": ([100.0, 90.0, 80.0, 70.0, 0.5, 60.0],
                                   [0.2, 0.15, 0.18, 0.21, 294.0, 0.2], True),
    "needs_history": ([100.0, 90.0, 0.5], [0.2, 0.2, 294.0], True),
    "needs_positive_median": ([100.0] * 5 + [0.5], [0.0] * 5 + [294.0], True),
    "off_under_parity_step": ([100.0, 90.0, 80.0, 70.0, 0.5, 60.0],
                              [0.2, 0.15, 0.18, 0.21, 294.0, 0.2], False),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_best_guard_matches_jax(tmp_path, case):
    fgds, divs, fused = GUARD_CASES[case]
    args = (fgds, divs, 100)
    port = _drive(True, tmp_path, *args, fused=fused, n_batches=1, with_gan=False)
    ref = _drive(False, tmp_path, *args, fused=fused, n_batches=1, with_gan=False)
    _assert_same(port, ref)
    want_best = {"refuses_degenerate_minimum": 60.0}.get(case, 0.5)
    assert port["best"] == want_best
    assert ((4, 0.5) in port["bests"]) == (case == "off_under_parity_step")


# a sustained degenerate regime: four accepted epochs at diversity 0.2,
# then improving FGDs at 15x that diversity
SUSTAINED = ([100.0, 90.0, 80.0, 70.0, 5.0, 4.0, 3.0, 2.0, 1.0],
             [0.2, 0.2, 0.2, 0.2, 3.0, 3.0, 3.0, 3.0, 3.0])


def test_refused_epochs_stay_out_of_the_guards_history(tmp_path):
    """hop_tpu's history takes in the refused epochs' 3.0s until its median
    is 1.6 and accepts the ninth epoch's degenerate FGD as best; the port's
    history stays at the accepted epochs and refuses all five. The loops
    agree on everything else: the saves, the JSONL lines but the refusals."""
    port = _drive(True, tmp_path, *SUSTAINED, 100, n_batches=1, with_gan=False)
    ref = _drive(False, tmp_path, *SUSTAINED, 100, n_batches=1, with_gan=False)
    assert ref["best"] == 1.0 and ref["bests"][-1] == (8, 1.0)
    assert port["best"] == 70.0 and port["bests"][-1] == (3, 70.0)
    refused = [line["step"] for line in port["lines"]
               if line["name"] == "best_guard_refused/val"]
    assert refused == [4, 5, 6, 7, 8]
    assert port["calls"] == ref["calls"]
    assert [s for s, _ in port["saved"]] == [s for s, _ in ref["saved"]]
    assert port["saved"][-1][1]["div_history"] == [0.2] * 4
    drop = {"best_guard_refused/val"}
    assert ([line for line in port["lines"] if line["name"] not in drop]
            == [line for line in ref["lines"] if line["name"] not in drop])


def test_resumed_guard_decides_as_the_uninterrupted_run(tmp_path):
    """A run resumed after epoch 5 with the history and best FGD its last
    save recorded refuses (epochs 6-8) and accepts (epoch 9, diversity back
    at 0.25) exactly as the uninterrupted run does."""
    fgds, divs = SUSTAINED[0] + [0.5], SUSTAINED[1] + [0.25]
    full = _drive(True, tmp_path, fgds, divs, 100, n_batches=1, with_gan=False)
    assert full["bests"][-1] == (9, 0.5)
    meta = full["saved"][5][1]
    rest = _drive(True, tmp_path, fgds, divs, 100, n_batches=1, with_gan=False,
                  start_epoch=6, div_history=meta["div_history"],
                  best_fgd=meta["best_fgd"])
    assert rest["bests"] == [b for b in full["bests"] if b[0] >= 6]
    assert rest["saved"] == full["saved"][6:]
    assert rest["best"] == full["best"] == 0.5


def test_metrics_fetched_once_per_log_every(tmp_path, monkeypatch):
    """The step's metrics stay on the device: one stacked copy per
    `log_every` steps, plus one at the epoch's end for a ragged rest."""
    stacks = []
    real = torch.stack
    monkeypatch.setattr(loops.torch, "stack", lambda t, *a, **k: (stacks.append(len(t)),
                                                                   real(t, *a, **k))[1])
    _drive(True, tmp_path, [5.0, 4.0], [1.0, 1.0], 0, n_batches=5, log_every=2)
    # epoch 0 (warmup, 1 metric): 2 + 2 + 1; epoch 1 (GAN, 2 metrics): 4 + 4 + 2
    assert stacks == [2, 2, 1, 4, 4, 2]


# tests/test_prefetch.py:23-55
def test_prefetch_iter_preserves_order_and_items():
    items = [{"i": torch.full((3,), k)} for k in range(17)]
    out = list(prefetch_iter(iter(items), depth=4))
    assert len(out) == 17
    for k, b in enumerate(out):
        assert torch.equal(b["i"], torch.full((3,), k))


def test_prefetch_iter_depth_zero_is_passthrough():
    gen = (k for k in range(5))
    assert list(prefetch_iter(gen, depth=0)) == [0, 1, 2, 3, 4]


def test_prefetch_iter_reraises_producer_exception():
    def boom():
        yield 1
        yield 2
        raise ValueError("producer died")

    it = prefetch_iter(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer died"):
        list(it)


def test_prefetch_iter_early_close_stops_producer():
    """Leaving the consumer loop early must not hang or leak the bounded
    queue: closing the generator stops and joins the producer."""
    import threading
    it = prefetch_iter(iter(range(1000)), depth=2)
    assert next(it) == 0
    it.close()
    assert not any(t.name == "hop-batch-prefetch" for t in threading.enumerate())


def test_run_training_prefetch_trajectory_identical():
    """run_training with prefetch=2 replays the synchronous trajectory: the
    same batches in the same order, the same per-step random sources."""
    cfg = tcfg.tiny_test_config("TED")

    class Step:
        def for_epoch(self, epoch):
            return self

        def __call__(self, state, batch, rng):
            mix = batch["x"].sum() + torch.rand((), generator=rng, dtype=torch.float64)
            state.n = state.n * 1.5 + mix
            return state, {"loss": torch.tensor(0.0)}

    def batches(epoch):
        for k in range(5):
            yield {"x": torch.full((2, 3), epoch * 10 + k, dtype=torch.float64)}

    runs = {}
    for depth in (0, 2):
        state, _ = run_training(
            cfg, batches, Step(), None, FakeState(torch.zeros((), dtype=torch.float64)),
            rng=lambda epoch, i: torch.Generator().manual_seed(1000 * epoch + i),
            epochs=3, log_every=2, prefetch=depth)
        runs[depth] = state.n
    assert torch.equal(runs[0], runs[2])
