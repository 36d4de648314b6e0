"""Weights from the seed, made on the device in one draw.

Every tensor of a spec list (name, shape) is cut from one flat N(0, 1)
draw of a generator seeded with `seed` on `device`, in the order of the
names sorted, so the same seed gives the same tensors on both sides of the
check. Scales: a matrix or a convolution N(0, 1 / fan_in) (fan_in: every
axis but the first); a bias 0.02 N(0, 1); a norm's scale 1 + 0.02 N(0, 1);
BatchNorm's running mean 0 and variance 1, its step count 0.
"""

from __future__ import annotations

import math

import torch


def make(specs, seed: int, device) -> dict:
    specs = sorted(specs)
    drawn = [(n, s) for n, s in specs if not n.endswith("num_batches_tracked")]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in specs:
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        z = flat[pos:pos + n].view(shape)
        pos += n
        if name.endswith("running_mean"):
            t = torch.zeros_like(z)
        elif name.endswith("running_var"):
            t = torch.ones_like(z)
        elif len(shape) >= 2:
            t = z * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("bias"):
            t = z * 0.02
        else:
            t = 1.0 + 0.02 * z
        out[name] = t
    return out
