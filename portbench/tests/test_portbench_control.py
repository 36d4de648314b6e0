"""On the card: the control (the plain reference in TF32, the next
precision below the configurations' f32 with TF32 off) put in the port's
place must read as not correct, and sound runs of the port as correct, at
a size a test run holds: the cell's widths with a two-layer backbone and a
batch of 32.

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

from __future__ import annotations

import pytest

from portbench import calibrate, cells
from portbench.check import judge


def small(name: str, batch: int):
    cell = cells.load_cell(name)
    conf = dict(cell.conf, llm=dict(cell.conf["llm"], n_layers=2))
    traffic = dict(cell.traffic, batch=batch, clips=8, pool=2)
    return cells.Cell(cell.name, conf, traffic, cell.limits, cell.end_to_end, cell.per_layer)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hop_expressive.train_gan_b256", "hop_ted.generate_b1024"])
def test_control_fails_and_port_passes(card, name):
    cell = small(name, 32)
    for seed in (11, 12, 13):
        got = calibrate.readings(cell, seed, card, control=True)
        assert judge(got["port"], cell.limits)[0], (seed, got)
        assert not judge(got["control"], cell.limits)[0], (seed, got)
