"""The training loop's per-step random generator (port of
hop_tpu/utils/prng.py by intent).

`hop_tpu` derives a step's key as `fold_in(fold_in(train_key(seed), epoch),
i)` (train/loops.py:180, :212-213), so a run's trajectory is a pure function
of (seed, epoch, iteration) and a resumed run replays the epochs it missed
exactly. The port keeps that property with its own fixed mixing: the three
integers go through `numpy.random.SeedSequence([seed, epoch, i])`, whose
first 63 bits seed a fresh CPU `torch.Generator`. No global RNG state is
read or written. The step draws its `train.llm.StepNoise` from that
generator, and the large dropout masks from a device generator seeded by
one of those draws.

The draws cannot equal threefry's; a test hands JAX's draws to the loop
through its `rng` argument instead. `hop_tpu`'s choice between the rbg and
threefry implementations is a TPU mechanism with no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


def step_seed(seed: int, epoch: int, i: int) -> int:
    """The 63-bit seed of step `i` of `epoch` in a run seeded `seed`."""
    state = np.random.SeedSequence([seed, epoch, i]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def step_generator(seed: int, epoch: int, i: int) -> torch.Generator:
    """A fresh CPU generator for step `i` of `epoch`."""
    return torch.Generator().manual_seed(step_seed(seed, epoch, i))
