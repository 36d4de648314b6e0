"""Dropout bits for the port: a counter-based hash for the attention kernel,
and plain Bernoulli dropout from an explicit generator for everything else.

Kernel K1 draws its attention-dropout mask inside the kernel, in the
forward and again in the backward. The TPU kernel seeded its hardware PRNG
per (call, batch block, head) (hop_tpu/ops/pallas_attention.py:74-97,
`_random_bits`/`_keep_mask`), so its mask depends on the block shape. Here
the bits are a hash of GLOBAL coordinates, so the CUDA kernel (any tiling)
and the plain torch version draw the same mask bit for bit:

    hk   = fmix32(seed + 0x9E3779B9 * (h + 1))
    rk   = fmix32(hk   + 0x85EBCA77 * (row + 1))     row = b * L + l
    bits = fmix32(rk   + 0xC2B2AE3D * (s + 1))

all in uint32 arithmetic, fmix32 being MurmurHash3's finaliser (the mixer
`_random_bits` uses in interpret mode). Each step is a bijection of its
input, so for one (seed, h, row) distinct keys s get distinct bits. An
element is kept when bits >= rate * 2^32 and then scaled by 1 / (1 - rate),
as `_keep_mask` does. csrc/dropout_bits.cuh is the device side.

torch has no uint32 arithmetic, so the plain version keeps the words in
int64 and takes each product's low 32 bits by 16-bit halves (no int64
overflow anywhere).
"""

from __future__ import annotations

from typing import Optional

import torch

MASK32 = 0xFFFFFFFF
HEAD_MULT = 0x9E3779B9
ROW_MULT = 0x85EBCA77
COL_MULT = 0xC2B2AE3D


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c for int64 x in [0, 2^32) and a constant c."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 words in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix_in(key: torch.Tensor, mult: int, idx: torch.Tensor) -> torch.Tensor:
    return fmix32((key + _mul32(idx + 1, mult)) & MASK32)


def threshold(rate: float) -> int:
    """Keep an element when its bits are >= this (uint32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * 2 ** 32)


def attention_bits(seed: int, B: int, L: int, H: int, S: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """(B, H, L, S) int64 words in [0, 2^32): the bits the kernel draws for
    query row (b, l) of head h against key s."""
    i64 = dict(dtype=torch.int64, device=device)
    seed_w = torch.tensor(seed & MASK32, **i64)
    hk = _mix_in(seed_w, HEAD_MULT, torch.arange(H, **i64))          # (H,)
    rows = torch.arange(B * L, **i64).reshape(B, 1, L)
    rk = _mix_in(hk.reshape(1, H, 1), ROW_MULT, rows)                 # (B, H, L)
    cols = torch.arange(S, **i64)
    return _mix_in(rk[..., None], COL_MULT, cols)                     # (B, H, L, S)


def attention_keep(seed: int, rate: float, B: int, L: int, H: int, S: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """(B, H, L, S) f32 mask in {0, 1 / (1 - rate)}: the kernel's dropout."""
    bits = attention_bits(seed, B, L, H, S, device)
    return (bits >= threshold(rate)).float() / (1.0 - rate)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli(1 - rate) dropout with the mask drawn from `generator` (on
    x's device), scaled by 1 / (1 - rate). Rate 0 returns x."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)
