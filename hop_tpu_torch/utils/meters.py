"""Running averages for loss reporting (port of hop_tpu/utils/meters.py).

Counterpart of the reference's bytecode-only utils/average_meter.py, used
by the epoch loop as run_ted.py:370-372,421-432 uses it.
"""

from __future__ import annotations


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
                ).format(**self.__dict__)
