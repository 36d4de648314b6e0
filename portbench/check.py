"""The numbers that decide `correct`, each against its limit.

Training cells (the port's first three steps against the reference's on
the same weights, batches and draws):

* `loss_gap`: the widest relative gap of a loss term (Huber, KLD, the
  diversity term, the G and the D term) of the first step. The later
  steps' terms are not compared: after one Adam step the diversity term
  falls near zero (3e-2 to 2e-4 on TED), and its relative gap between two
  sound computations swings to 0.5 (`loss_detail` prints every step's);
* `grad_gap`: the first step's gradient, by leaf: the gap between the
  port's norm (read from Adam's first moment after one step, 2 m for
  beta1 = 0.5) and the reference's, over the reference's norm of that
  leaf; the worst leaf;
* `change_gap`: the same of each leaf's change after three steps.

Both leave out the leaves whose first gradient in the reference is under
a thousandth of the median leaf's: a gradient nought to rounding (the key
projection's bias under the softmax) is all round-off, and moves its leaf
under Adam by round-off alone. Every other leaf is held to its own norm,
so a small leaf that is wrong fails as a large one does.

A leaf the port's optimizer holds no state for reads a norm of 0.

Generation cells: `pose_gap`, the widest absolute gap of a pose coordinate
over the sampled calls of the window.
"""

from __future__ import annotations

import statistics


def _relative(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(abs(r), floor)


def loss_gap(prog: list, ref: list) -> float:
    """The first step's widest relative gap of a loss term."""
    return max(_relative(prog[0][k], ref[0][k], 1e-6) for k in ref[0])


def loss_detail(prog: list, ref: list) -> list:
    """Each step's relative gap of each loss term, and the loss term values."""
    return [{k: [_relative(p[k], r[k], 1e-6), p[k], r[k]] for k in r} for p, r in zip(prog, ref)]


def leaf_gap(prog: dict, ref: dict, leaves: list) -> float:
    """The widest gap of a leaf's norm, over the reference's norm of it."""
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], 1e-30) for k in leaves)


def moved_leaves(ref_grad: dict) -> list:
    median = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= 1e-3 * median)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [per-step terms], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    leaves = moved_leaves(ref["grad"])
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], leaves),
            "change_gap": leaf_gap(prog["change"], ref["change"], leaves)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    compared, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared
