"""The device's timeline of a traced window, from torch.profiler's trace.

The trace is written as Chrome trace JSON to a temporary file and read back:
device operations (kernels, copies, sets) with their start and length, the
host's runtime launches (which tie each kernel to the instant it was
enqueued), the host's operators and the named ranges (torch's own, such as
`Optimizer.step#Adam.step`, and the benchmark's `portbench.*` spans). The
window is the benchmark's `portbench.window` range; device time outside it
is left out.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


class Trace:
    def __init__(self, prof, window_s: float = None):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.device, self.ranges, self.host_ops, launch = [], [], [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e["name"], e.get("args", {}).get("correlation")))
            elif cat == "user_annotation":
                self.ranges.append((ts, ts + dur, e["name"]))
            elif cat == "cpu_op":
                self.host_ops.append((ts, ts + dur, e["name"]))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = ts
        self.launch = launch
        if window_s is not None:
            self.device.sort()
            self.start = min((a for a, _, _, _ in self.device), default=0.0)
            self.end = max((b for _, b, _, _ in self.device), default=0.0)
            self.window_s = window_s
            return
        windows = [r for r in self.ranges if r[2] == WINDOW]
        if not windows:
            raise ValueError(f"the trace holds no {WINDOW} range")
        self.start, self.end = windows[0][0], windows[0][1]
        self.device = sorted((max(a, self.start), min(b, self.end), n, c)
                             for a, b, n, c in self.device if b > self.start and a < self.end)
        self.window_s = (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list:
        merged = []
        for a, b, _, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds(self, match) -> float:
        """Device time of the operations whose name `match` accepts."""
        return sum(b - a for a, b, n, _ in self.device if match(n)) * 1e-6

    def seconds_under(self, range_name: str) -> float:
        """Device time of the operations enqueued inside the host ranges
        named `range_name`."""
        spans = sorted((a, b) for a, b, n in self.ranges if n == range_name)
        starts = [a for a, _ in spans]
        total = 0.0
        for a, b, _, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += b - a
        return total * 1e-6

    def _innermost(self, items, t):
        best = None
        for a, b, n in items:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return best[2] if best else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing as each began."""
        by_name = {}
        for a, b, n, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps, prev = [], self.start
        for a, b in busy:
            if a > prev:
                gaps.append((a - prev, prev))
            prev = max(prev, b)
        if self.end > prev:
            gaps.append((self.end - prev, prev))
        gaps.sort(reverse=True)
        spans = [r for r in self.ranges if r[2].startswith("portbench.") and r[2] != WINDOW]
        named = []
        for length, t in gaps[:top]:
            span = self._innermost(spans, t) or "no span"
            op = self._innermost(self.host_ops, t) or "idle host"
            named.append([f"{span} / {op}"[:64], length * 1e-6])
        return {"device_ops": [[n[:64], s] for n, s in ops], "idle_gaps": named}
