"""Readings for a cell's limits: the compared numbers of sound runs of the
port over many seeds, of the control (the reference itself in the next
precision down, TF32, put in the port's place) and of planted faults, at the
cell's own size, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control-seeds ...] [--faults half_batch lr_high --fault-seeds ...]

A training cell's readings need no window: its compared steps are its
set-up. A generation cell runs calls until its sampled ones are done.
Prints one JSON line per reading and a summary: for each number the
largest sound reading and the smallest control and fault readings; and on
standard error what the kind's driver details beside them (a training
cell: every step's loss terms, every compared leaf's two norms).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, faults  # noqa: E402


def readings(cell, seed: int, device, control: bool, fault: str = None,
             details: list = None) -> dict:
    """The compared numbers of one seed: {"port": ...} (the port, with
    `fault` planted if given) and with `control` {"control": ...}. What the
    driver details beside them is appended to `details`."""
    driver = cells.kind_driver(cell.traffic["kind"], cell.root)(cell, seed, device)
    try:
        with faults.planted(fault) if fault else contextlib.nullcontext():
            driver.setup()
            driver.calibration_calls()
        driver.release()
        ref = driver.reference()
        mode = f"fault:{fault}" if fault else "port"
        out = {mode: driver.numbers(ref)}
        if details is not None:
            details.append([mode, driver.detail(ref)])
        if control:
            ctl = driver.reference(control=True)
            out["control"] = driver.numbers(ref, ctl)
            if details is not None:
                details.append(["control", driver.detail(ref, ctl)])
        return out
    finally:
        driver.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[],
                   help="seeds whose control readings are taken too")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    rows = ([(s, s in args.control_seeds, None) for s in args.seeds]
            + [(s, True, None) for s in args.control_seeds if s not in args.seeds]
            + [(s, False, f) for f in args.faults for s in args.fault_seeds])
    seen = {}
    for seed, control, fault in rows:
        details = []
        for mode, numbers in readings(cell, seed, args.device, control, fault,
                                      details).items():
            print(json.dumps({"workload": cell.name, "mode": mode, "seed": seed, **numbers}),
                  flush=True)
            seen.setdefault(mode, []).append(numbers)
        for mode, detail in details:
            print(json.dumps({"seed": seed, "mode": mode, **detail}), file=sys.stderr)
    summary = {}
    for mode, got in seen.items():
        pick = max if mode == "port" else min
        summary[mode] = {k: pick(r[k] for r in got) for k in got[0]}
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
