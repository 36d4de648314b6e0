"""The epoch loop of a training run (port of hop_tpu/train/loops.py).

Counterpart of the epoch loop in reference run_ted.py:374-466: each batch
goes to the model's train step, the warmup step until the GAN gate opens
(`epoch > cfg.loss.warmup_epochs`) and the GAN step after, each in its
`for_epoch` variant; losses are averaged by AverageMeters and printed
every `log_every` steps with s/iter; the validation pass runs after every
epoch, its scalars go to a JSONL stream, and checkpoints are saved on the
best FGD (behind a degeneracy guard) and on a cadence, for resume.

The step's metrics stay on the device and are fetched once per `log_every`
steps, in one copy: a fetch per step would make the host wait for the card
every step, and the next batch could not be made while the card runs this
one. `prefetch` makes batches ahead on a background thread.

`hop_tpu`'s `jax.transfer_guard` has no counterpart in PyTorch; its
purpose, catching work in the hot loop that makes the host wait for the
device, is served by `torch.cuda.set_sync_debug_mode` ("warn" or "error")
around the loop. Fetching the metrics at the logging boundary is the one
sanctioned wait and runs outside it.

On a rank of a parallel run (`mesh`) every rank runs the loop on its rows;
the steps hand back metrics already reduced over the batch group, and the
validation pass returns the same numbers on every rank, so every rank
takes each branch (the GAN gate, the best-FGD guard, save-on-best) from
the same numbers. Every rank builds the state to save (ZeRO's moments are
gathered, a collective); rank 0 alone writes it, the metrics stream and
the profile, and prints, and a barrier follows each save.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.eval.evaluate import EvalResult
from hop_tpu_torch.parallel.collectives import barrier
from hop_tpu_torch.utils.meters import AverageMeter
from hop_tpu_torch.utils.metrics_export import TensorBoardMirror
from hop_tpu_torch.utils.profiling import start_trace, stop_trace

METER_NAMES = ("loss", "var_loss", "gen", "dis", "KLD", "DIV_REG",
               "c_pos", "c_neg", "phy")

# Degenerate-minimum guard for best-checkpoint selection (hop_tpu round 5):
# an FGD improvement whose eval diversity is this many times the median of
# the run's earlier accepted epochs is refused as "best" (it is still saved
# on the periodic schedule). Active for the fused step; the 3-forward step
# keeps the reference's bare save-on-best criterion (run_ted.py:454-462).
BEST_GUARD_DIV_RATIO = 10.0
BEST_GUARD_MIN_HISTORY = 4

# --transfer-guard -> torch.cuda.set_sync_debug_mode
SYNC_DEBUG_MODES = {"off": 0, "log": "warn", "disallow": "error"}


def prefetch_iter(it: Iterable, depth: int):
    """Run `it` on a background thread, keeping up to `depth` items ready,
    so that host batch assembly and the copy to the card overlap with the
    card running the previous step (the reference gets the same overlap from
    DataLoader num_workers, run_ted.py:229). Order is preserved, so a run's
    trajectory is the synchronous loop's, bit for bit. An exception raised
    by the producer is raised again at the consumer. The producer enqueues
    its device work on the legacy default stream, as the consumer does, so
    the card runs the two in order."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:   # raised again by the consumer
            put(e)
            return
        put(end)

    t = threading.Thread(target=worker, daemon=True, name="hop-batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)


class MetricWriter:
    """JSONL scalar stream (the reference's TensorBoard scalars); with
    `tensorboard_dir` also mirrored live into a TensorBoard event file
    (`utils.metrics_export.TensorBoardMirror`)."""

    def __init__(self, path: Optional[str], tensorboard_dir: Optional[str] = None):
        self._f = open(path, "a") if path else None
        self._tb = TensorBoardMirror(tensorboard_dir) if tensorboard_dir else None

    def scalar(self, name: str, value: float, step: int):
        if self._f:
            self._f.write(json.dumps(
                {"name": name, "value": float(value), "step": step}) + "\n")
            self._f.flush()
        if self._tb:
            self._tb.scalar(name, value, step)

    def close(self):
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()


@contextlib.contextmanager
def sync_debug(mode):
    """torch.cuda.set_sync_debug_mode(mode) inside, the previous mode after."""
    if not torch.cuda.is_available():
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _batch_size(batch) -> int:
    return next(iter(batch.values())).shape[0]


def run_training(cfg: Config,
                 train_batches_fn: Callable[[int], Iterable[dict]],
                 warmup_step, gan_step, state,
                 rng: Callable[[int, int], object],
                 eval_fn: Optional[Callable[[object, int], EvalResult]] = None,
                 checkpoint_manager=None,
                 metric_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 log_every: int = 100,
                 epochs: Optional[int] = None,
                 start_epoch: int = 0,
                 best_fgd: float = float("inf"),
                 checkpoint_every: int = 1,
                 profile_dir: Optional[str] = None,
                 transfer_guard: str = "off",
                 prefetch: int = 0,
                 div_history: Optional[list] = None,
                 mesh=None):
    """Runs the schedule from `start_epoch`; returns (state, best_fgd).

    rng(epoch, i): the random source of step i of `epoch`, handed to the step
    (`utils.prng.step_generator` bound to the run's seed, or a test's
    `StepNoise`). With the batch order seeded per epoch by the caller, the
    trajectory is a pure function of (seed, epoch, iteration): a run resumed
    from the checkpoint of epoch k with `start_epoch=k+1` replays epochs
    k+1.. of the uninterrupted run bit for bit.

    transfer_guard: "off" | "log" | "disallow" — `torch.cuda.
    set_sync_debug_mode` "warn" / "error" around the hot loop (batches and
    steps): an operation that makes the host wait for the card warns or
    raises. The validation pass, the checkpoint, the metric fetch and the
    profiler's stop run outside it. The mode is process-wide, so with
    `prefetch` the producer thread's batches are covered too, except for
    what it makes while the loop fetches the metrics. "off" leaves the mode
    untouched.

    prefetch: make up to N batches ahead on a background thread
    (`prefetch_iter`).

    div_history: the diversities of the accepted validation epochs so far
    (the best-FGD guard's history), from the checkpoint's metadata on a
    resume. Every save records it, so the guard of a resumed run decides as
    the uninterrupted run's does.

    mesh: this rank's place in a parallel run (see the module's docstring).
    """
    epochs = epochs or cfg.train.epochs
    main = mesh is None or mesh.is_main
    say = print if main else (lambda *a, **k: None)
    if not main:
        metric_path = tensorboard_dir = profile_dir = None
    sync_mode = SYNC_DEBUG_MODES[transfer_guard]

    def guarded(mode=sync_mode):
        """The hot loop's sync-debug mode; guarded(0) lifts it. Nothing
        when the guard is off."""
        return sync_debug(mode) if sync_mode else contextlib.nullcontext()

    meters = {n: AverageMeter(n) for n in METER_NAMES}
    writer = MetricWriter(metric_path, tensorboard_dir)
    # best-checkpoint degeneracy guard: fused-step runs only (the 3-forward
    # step mirrors the reference's bare criterion, run_ted.py:454-462)
    guard_best = cfg.hop.fused_step
    div_history = list(div_history or [])
    iter_count = 0
    time_now = time.time()
    # profile_dir: a torch.profiler trace of steps 2-5 of the first epoch
    # (step 1 pays the kernels' first launches)
    profiler = None

    for epoch in range(start_epoch, epochs):
        epoch_start = time.time()
        use_gan = (gan_step is not None
                   and epoch > cfg.loss.warmup_epochs
                   and cfg.loss.gan_weight > 0.0)
        step_fn = gan_step if use_gan else warmup_step
        if hasattr(step_fn, "for_epoch"):
            # reference LLM-dropout dynamics: the frozen backbone is in eval
            # mode during epoch 0 only (train/llm.py EpochStep)
            step_fn = step_fn.for_epoch(epoch)

        pending: list = []

        def drain():
            """Fetch the pending metrics in one copy and feed the meters."""
            if not pending:
                return
            names = [sorted(m) for m, _ in pending]
            flat = torch.stack([m[k].float() for (m, _), ks in zip(pending, names)
                                for k in ks]).cpu().tolist()
            pos = 0
            for (_, bsz), ks in zip(pending, names):
                vals = dict(zip(ks, flat[pos:pos + len(ks)]))
                pos += len(ks)
                for name, meter in meters.items():
                    if name in vals:
                        meter.update(vals[name], bsz)
            pending.clear()

        batches = prefetch_iter(train_batches_fn(epoch), prefetch)
        try:
            with guarded():
                for i, batch in enumerate(batches):
                    iter_count += 1
                    if profile_dir and epoch == start_epoch and i == 1:
                        with guarded(0):
                            profiler = start_trace()
                    state, metrics = step_fn(state, batch, rng(epoch, i))
                    pending.append((metrics, _batch_size(batch)))
                    if profiler is not None and i >= 4:
                        with guarded(0):
                            _stop_profiler(profiler, profile_dir)
                        profiler = None
                    if (i + 1) % log_every != 0:
                        continue
                    with guarded(0):
                        drain()
                    summary = f"\titers: {i + 1}, epoch: {epoch + 1} "
                    for meter in meters.values():
                        if meter.count > 0:
                            summary += f"{meter.name}: {meter.avg:.3f}, "
                            meter.reset()
                    speed = (time.time() - time_now) / iter_count
                    say(summary)
                    say(f"\tspeed: {speed:.4f}s/iter")
                    time_now = time.time()
                    iter_count = 0
        finally:
            batches.close()

        drain()
        if profiler is not None:   # the epoch had fewer than 5 steps
            _stop_profiler(profiler, profile_dir)
            profiler = None
        say(f"Epoch: {epoch + 1} cost time: {time.time() - epoch_start:.3f}s")

        if eval_fn is not None:
            eval_start = time.time()
            result = eval_fn(state, epoch)
            say(str(result))
            say(f"Validation: {time.time() - eval_start:.3f}s")
            writer.scalar("diversity_score/val", result.diversity, epoch)
            writer.scalar("val_frechet_dist/val", result.frechet_dist, epoch)
            writer.scalar("BC/val", result.bc, epoch)
            writer.scalar("loss/val", result.loss, epoch)

            improved = result.frechet_dist < best_fgd
            degenerate = False
            if improved and guard_best and len(div_history) >= BEST_GUARD_MIN_HISTORY:
                med = float(np.median(div_history))
                if med > 0 and result.diversity > BEST_GUARD_DIV_RATIO * med:
                    degenerate = True
                    improved = False
                    say(f"  !!! best-FGD candidate REFUSED: diversity "
                          f"{result.diversity:.2f} is "
                          f"{result.diversity / med:.1f}x the run median "
                          f"{med:.3f}: a degenerate high-diversity minimum, "
                          f"not a converged gesture mode; checkpoint still "
                          f"saved on the periodic schedule, best-FGD unchanged")
                    writer.scalar("best_guard_refused/val", result.frechet_dist, epoch)
            # a refused epoch stays out of the history: a degenerate regime
            # must not raise the median it is measured against
            if not degenerate:
                div_history.append(float(result.diversity))
            if checkpoint_manager is not None and (
                    improved or degenerate
                    or (epoch + 1) % checkpoint_every == 0
                    or epoch == epochs - 1):
                saved = state.state_dict()      # every rank: ZeRO gathers
                if main:
                    checkpoint_manager.save(epoch, saved, metadata={
                        "fgd": result.frechet_dist, "bc": result.bc,
                        "epoch": epoch,
                        "best_fgd": (best_fgd if degenerate else
                                     min(best_fgd, result.frechet_dist)),
                        "div_history": list(div_history)})
                    if improved:
                        checkpoint_manager.record_best("frechet", result.frechet_dist,
                                                       epoch)
                        say(f"Saved the checkpoint (best FGD {result.frechet_dist:.3f})")
                del saved
                if mesh is not None:
                    barrier()
            if improved:
                best_fgd = result.frechet_dist
            say(f"  *** BEST VALIDATION FGD: {best_fgd:.3f}")

    writer.close()
    return state, best_fgd


def _stop_profiler(profiler, profile_dir: str) -> None:
    stop_trace(profiler, profile_dir)
    print(f"profile trace written to {profile_dir}")
