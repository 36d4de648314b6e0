"""Checkpoints of a training run (port of hop_tpu/utils/checkpoint.py).

A save is one `torch.save` file, `ckpt_<step>.pt` (the step is the epoch, as
in `hop_tpu`), of what `train.state.GANTrainState.state_dict()` gives: the
generator's state_dict without the frozen backbone (`strip_frozen`), the
discriminator's, both optimizers' and the step count. It is written to a
temporary file, flushed to the disk and renamed into place; only then is
`run_metadata.json` rewritten, itself by a rename, with the save's step
among its keys. `latest_step` reads that step, so a crash between the two
writes leaves a resume on the older save, whose metadata (epoch, best FGD)
it reads. The three newest saves are kept. `record_best` keeps the best
value of a metric in `best_metrics.json`.

`restore` reads with `torch.load(weights_only=True)` onto the CPU; the
caller's `load_state_dict` moves tensors to the parameters' device (Adam
keeps its step counts on the CPU, as it made them).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import torch

#: the frozen backbone's prefix in the generator's state_dict
FROZEN_PREFIX = "llm_model."
_CKPT = re.compile(r"ckpt_(\d+)\.pt")


def strip_frozen(state_dict: dict, prefix: str = FROZEN_PREFIX):
    """(stripped, frozen): the generator's state_dict split into what is
    saved and the frozen backbone's entries.

    The backbone is frozen (reference HOP.py:90-91) and rebuilt from the
    config and the seed, so saving its weights with every checkpoint only
    slows saves and restores."""
    stripped = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    frozen = {k: v for k, v in state_dict.items() if k.startswith(prefix)}
    return stripped, frozen


def reattach_frozen(stripped: dict, frozen: dict) -> dict:
    """The inverse of strip_frozen (pass the entries of a fresh build)."""
    return {**stripped, **frozen}


def flat_entries(tree, path: str = "") -> dict:
    """A saved state's leaves (tensors, numbers, strings) by path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_entries(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat_entries(sub, f"{path}/{i}").items()}
    return {path: tree}


def differing_entries(a, b) -> list:
    """The paths at which two saved states differ, tensors bit for bit."""
    a, b = flat_entries(a), flat_entries(b)
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b
                  or not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                          else a[k] == b[k]))


def _write_atomically(path: Path, write) -> None:
    """write(file) into a temporary file beside `path`, flushed to the disk,
    then renamed onto `path`."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._meta_path = self.directory / "run_metadata.json"
        self._best_path = self.directory / "best_metrics.json"

    # static run metadata (model name, speaker count, seed, ...) merged into
    # every save's metadata; set by the training entry point
    metadata: dict = None

    def path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.pt"

    def save(self, step: int, state: dict, metadata: Optional[dict] = None):
        _write_atomically(self.path(step), lambda f: torch.save(state, f))
        # the metadata only AFTER the arrays are durable: it names the step
        # a resume restores and the epoch it resumes after
        merged = dict(self.metadata or {})
        merged.update(metadata or {})
        merged["step"] = step
        meta = {k: v for k, v in merged.items()
                if isinstance(v, (str, int, float, bool))
                or (isinstance(v, list) and all(isinstance(x, float) for x in v))}
        _write_atomically(self._meta_path, lambda f: f.write(json.dumps(meta).encode()))
        for old in self.all_steps()[:-self.max_to_keep]:
            if old != step:
                self.path(old).unlink()

    def all_steps(self) -> list:
        """The steps of the saves on disk, oldest first."""
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _CKPT.fullmatch(p.name)))

    def run_metadata(self) -> dict:
        return json.loads(self._meta_path.read_text()) if self._meta_path.exists() else {}

    def latest_step(self) -> Optional[int]:
        """The step of the newest save whose metadata was written."""
        step = self.run_metadata().get("step")
        return step if step is not None and self.path(step).exists() else None

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def record_best(self, metric_name: str, value: float, step: int) -> bool:
        """Track the best value so far (lower is better, like FGD). Returns
        True when `value` improves, mirroring the reference's save-on-best
        gate."""
        best = {}
        if self._best_path.exists():
            best = json.loads(self._best_path.read_text())
        improved = value < best.get(metric_name, float("inf"))
        if improved:
            best[metric_name] = value
            best[f"{metric_name}_step"] = step
            self._best_path.write_text(json.dumps(best, indent=1))
        return improved
