"""Faults planted under the timed path, for the check's own tests and for
reading a limit's upper end: each is a context manager that patches the
port while it is active.

* `frozen_state`: every Adam step of the port does nothing, so a training
  step returns its state unchanged;
* `half_batch`: the training step sees half of each batch, its losses the
  mean over that half;
* `lr_high`: both of the port's Adams step at 1.1 times their learning
  rate: an optimizer update that is wrong by a tenth;
* `answer`: the evaluation forward returns its poses with one coordinate
  moved by 1.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def planted(name: str):
    if name == "frozen_state":
        import torch
        with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
            yield
    elif name == "half_batch":
        from hop_tpu_torch.train import llm
        real = llm.make_hop_train_steps

        def halved(step):
            def run(state, batch, rng):
                return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, rng)
            return run

        def make(*args, **kwargs):
            warmup, gan, init_state = real(*args, **kwargs)
            return warmup, llm.EpochStep(halved(gan.for_epoch(1)), halved(gan.for_epoch(0))), \
                init_state
        with mock.patch.object(llm, "make_hop_train_steps", make):
            yield
    elif name == "lr_high":
        from hop_tpu_torch.train import state
        real = state.rank_adam

        def adam(params, lr, *args, **kwargs):
            return real(params, 1.1 * lr, *args, **kwargs)
        with mock.patch.object(state, "rank_adam", adam):
            yield
    elif name == "answer":
        from hop_tpu_torch.models.hop import HOPModel
        real = HOPModel.forward

        def forward(self, *args, **kwargs):
            out, *rest = real(self, *args, **kwargs)
            moved = out.clone()
            moved[0, 0, 0] += 1.0
            return (moved, *rest)
        with mock.patch.object(HOPModel, "forward", forward):
            yield
    else:
        raise ValueError(f"no fault {name!r}")
