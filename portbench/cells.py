"""What one cell is, found by name: `BENCHMARK.json` at the checkout's root
names the cell's configuration and traffic mix, and the harness reads
`portbench/configs/<config>.json`, `portbench/traffic/<traffic>.json`,
`portbench/limits/<cell>.json` (the limits of its check), the driver of
the mix's `kind`, `portbench/kinds/<kind>.py`, and, for each per-layer
metric, `portbench/metrics/<metric>.py`. A later cell, mix, kind of
traffic or metric is new files and entries: no file here changes.

A kind's file defines `Driver(cell, seed, device)` with:

* `kind`: the kind's name, as the traffic file gives it;
* `setup()`: inputs and weights from the seed, every shape of the window
  warmed up, and the check's own readings where they come before the
  window; `phases` ({name: host seconds}) says where set-up went;
* `loop(until, spans, trace) -> units`: closed-loop work until
  `until(units)` holds; with `spans` it keeps host spans in `spans`
  ({name: [seconds]}), with `trace` it names its parts for the profiler;
* `end_to_end(units, window_s) -> {metric: value}`: the cell's own
  end-to-end values (the harness adds `setup_s` and `peak_mem_gib`);
* `failed`: units that failed; `release()`: the port's state freed;
* `reference(control=False)`, `numbers(ref, prog=None)`: the plain
  reference's outputs (or the control's) and the compared numbers;
  `calibration_calls()` and `detail(ref, prog=None)` for calibration;
* `close()`: what set-up made on disk removed, every thread stopped.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    conf: dict              # the configuration file
    traffic: dict           # the traffic file
    limits: dict            # number -> limit of the check
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int = 1
    root: Path = field(default=HERE)


def _reports(metric: dict, cell: str, moved: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in moved


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell `name` of `root`/../BENCHMARK.json, with its files."""
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, moved)]
    return Cell(name, conf, traffic, limits, e2e, per_layer, w.get("chips", 1), root)


def metric_reader(name: str, root: Path = HERE):
    """`read(ctx)` of `portbench/metrics/<name>.py`."""
    return _load(root / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_driver(kind: str, root: Path = HERE):
    """`Driver` of `portbench/kinds/<kind>.py`."""
    return _load(root / "kinds" / f"{kind}.py", f"portbench_kind_{kind}").Driver
