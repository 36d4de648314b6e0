"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`hop_tpu_torch/`). The cell
(`BENCHMARK.json`'s `workloads`) names a configuration and a traffic mix;
the harness finds their files by name (`portbench/cells.py`). It sets up
(inputs and weights from `--seed`, every shape of the window warmed up),
measures `--seconds` of closed-loop work, closed by a synchronize, and with
`--trace 1` then traces fixed stretches of the same loop under
torch.profiler and reports the per-layer metrics (`portbench/metrics/`).
The kind of traffic that the cell's mix names is driven by
`portbench/kinds/<kind>.py`. Last, it frees the port's state and works out
the compared outputs again with the plain reference; `correct` says whether
every compared number is within its limit (`portbench/limits/<cell>.json`).

The last line of standard output is one JSON object; the compared numbers
with their limits are the last lines of standard error and the line's last
key. Without a card (or with fewer than the cell asks for), or where the
port cannot be imported, it prints no result and exits with 2; where JAX or
the JAX package was loaded, with 3.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cells, check  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hop_tpu")
GIB = 2 ** 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's `hop_tpu_torch` is not `hop_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced(driver, steps: int, device):
    """The traced stretches after the window: `steps` units under a
    profiler of the device alone, whose cost to the host is small, for the
    device's timeline (busy, idle, kernels), its length read by a pair of
    events; then `steps` more under a profiler of host and device, for
    what ran under the host's ranges and what the host did in the gaps.
    Returns (device trace, its units, host trace, its units); on the CPU
    the one profile of the host serves as both."""
    from portbench.trace import WINDOW, Trace
    P = torch.profiler.ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    dev = dev_units = None
    if cuda:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[P.CUDA]) as prof:
            a.record()
            dev_units = driver.loop(lambda n: n >= steps, spans=False, trace=False)
            b.record()
            sync(device)
        dev = Trace(prof, window_s=a.elapsed_time(b) * 1e-3)
    with torch.profiler.profile(activities=[P.CPU, P.CUDA] if cuda else [P.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            host_units = driver.loop(lambda n: n >= steps, spans=False, trace=True)
            sync(device)
    host = Trace(prof)
    return (dev, dev_units, host, host_units) if cuda else (host, host_units, host, host_units)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             start: float = START) -> dict:
    """Set up, measure, optionally trace, then check one cell; the result's
    fields (`correct`, `attempted`, `failed`, `metrics`, `device`, and with a
    trace `breakdown`, then `compared`)."""
    cuda = torch.device(device).type == "cuda"
    driver = cells.kind_driver(cell.traffic["kind"], cell.root)(cell, seed, device)
    try:
        imports_s = time.perf_counter() - start
        driver.setup()
        sync(device)
        setup_s = time.perf_counter() - start
        print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                     {"start and imports": imports_s, **driver.phases}.items()),
              file=sys.stderr)
        if cuda:
            before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        units = driver.loop(lambda n: time.perf_counter() - t0 >= seconds, spans=True, trace=False)
        sync(device)
        window_s = time.perf_counter() - t0
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        values = {**driver.end_to_end(units, window_s), "setup_s": setup_s,
                  "peak_mem_gib": window_peak / GIB}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name() if cuda else "cpu",
               "count": 1, "memory_peak_bytes": max(before, window_peak) if cuda else 0}
        print(f"window: {units} units in {window_s:.4f} s", file=sys.stderr)
        if trace:
            tr, tr_units, host_tr, host_units = traced(driver, cell.traffic["trace_steps"], device)
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            print(f"traced: {tr_units} units in {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s "
                  f"(device alone); {host_units} in {host_tr.window_s:.4f} s, busy "
                  f"{host_tr.busy_s:.4f} s (host and device)", file=sys.stderr)
        driver.release()
        numbers = driver.numbers(driver.reference())
    finally:
        driver.close()
    correct, compared = check.judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": units, "failed": driver.failed}
    if trace:
        ctx = SimpleNamespace(kind=driver.kind, driver=driver, conf=cell.conf,
                              traffic=cell.traffic, batch=getattr(driver, "B", None),
                              spans=driver.spans, units=units, window_s=window_s,
                              trace=tr, traced_units=tr_units,
                              host_trace=host_tr, host_traced_units=host_units)
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=dev, breakdown=host_tr.breakdown())
    else:
        result.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                               for m in cell.end_to_end}, device=dev)
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the port builds its kernels and its record gatherer here, at fixed
    # paths inside the checkout, so that only a checkout's first run builds
    os.environ["HOP_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    os.environ["HOP_TPU_TORCH_NATIVE_DIR"] = str(ROOT / "build" / "native")
    try:
        import hop_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port cannot be imported from {ROOT}: {e}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
