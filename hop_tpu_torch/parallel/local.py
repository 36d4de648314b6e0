"""Ranks on this machine, launched as torchrun launches them: one process a
rank with RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT in its environment, on a free port of localhost. The training
entry points never spawn their own workers (a user runs them under
torchrun); this serves the dry run (`parallel.dryrun`), the tests and the
card's smoke run, which drive a few ranks from one process.

Each rank's output goes to a file of its own, read when every rank has
ended; a rank still running at the time limit is killed with the others,
so a hung collective fails instead of waiting for ever.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class RankResult:
    rank: int
    returncode: int
    output: str


def run_ranks(argv: list, world: int, timeout: float, env: dict | None = None,
              threads: int = 1) -> list:
    """Run `python argv...` as `world` ranks; returns a `RankResult` per rank
    (returncode -9 for a rank killed at `timeout` seconds). `threads` pins
    each rank's intra-op threads (OMP_NUM_THREADS)."""
    port = free_port()
    base = {**os.environ, **(env or {}), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "OMP_NUM_THREADS": str(threads),
            "MKL_NUM_THREADS": str(threads)}
    logs, procs = [], []
    try:
        for rank in range(world):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                env={**base, "RANK": str(rank), "LOCAL_RANK": str(rank)}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                break
            if any(p.poll() not in (None, 0) for p in procs):
                # a rank failed: the others would wait for it in a collective
                time.sleep(2.0)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        results.append(RankResult(rank, p.returncode, log.read()))
        log.close()
    return results


def check_ranks(results: list) -> str:
    """Rank 0's output when every rank ended with 0; else raises with each
    failed rank's output tail."""
    bad = [r for r in results if r.returncode != 0]
    if bad:
        raise RuntimeError("\n".join(
            f"--- rank {r.rank} exited {r.returncode}:\n{r.output[-4000:]}" for r in bad))
    return results[0].output
