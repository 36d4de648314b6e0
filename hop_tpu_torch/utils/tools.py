"""Training utilities of the reference's bytecode-only utils/tools.py (a
copy of hop_tpu/utils/tools.py): EarlyStopping, adjust_learning_rate,
dotdict, StandardScaler, del_files, cal_accuracy.
"""

from __future__ import annotations

import math
import shutil
from typing import Optional

import numpy as np


class dotdict(dict):
    """dict with attribute access."""
    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


class StandardScaler:
    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean


class EarlyStopping:
    """Stop when validation loss hasn't improved for `patience` epochs."""

    def __init__(self, patience: int = 7, verbose: bool = False,
                 delta: float = 0.0, save_fn=None):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.save_fn = save_fn
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.val_loss_min = math.inf

    def __call__(self, val_loss: float, state=None, path: str = None) -> bool:
        score = -val_loss
        if self.best_score is None or score > self.best_score + self.delta:
            self.best_score = score
            self._save(val_loss, state, path)
            self.counter = 0
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / "
                      f"{self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop

    def _save(self, val_loss, state, path):
        if self.verbose:
            print(f"Validation loss decreased "
                  f"({self.val_loss_min:.6f} --> {val_loss:.6f})")
        if self.save_fn is not None and state is not None:
            self.save_fn(state, path)
        self.val_loss_min = val_loss


def adjust_learning_rate(epoch: int, base_lr: float, lradj: str = "type1",
                         train_epochs: int = 75) -> float:
    """Stepwise / cosine LR schedules matching Time-LLM's tools variants.
    Returns the new LR (a pure function; set it on the optimizer's groups)."""
    if lradj == "type1":
        return base_lr * (0.5 ** ((epoch - 1) // 1)) if epoch >= 1 else base_lr
    if lradj == "type2":
        table = {2: 5e-5, 4: 1e-5, 6: 5e-6, 8: 1e-6, 10: 5e-7, 15: 1e-7,
                 20: 5e-8}
        keys = [k for k in sorted(table) if epoch >= k]
        return table[keys[-1]] if keys else base_lr
    if lradj == "COS":
        return base_lr / 2 * (1 + math.cos(epoch / train_epochs * math.pi))
    return base_lr


def del_files(dir_path: str):
    shutil.rmtree(dir_path)


def cal_accuracy(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    return float(np.mean(y_pred == y_true))
