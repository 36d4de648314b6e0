"""What the HOP kinds of traffic share (`portbench/kinds/train_gan.py`,
`generate.py`): the port's `Config` from a configuration file, the record
store the batches come from, the benchmark's weights for the port's nets
and for the plain reference, and the helpers of the check.

A HOP driver builds the port's nets on the meta device and fills them on
the card with the benchmark's weights (`weights.make`), makes its inputs
through the port's own input path, warms up every shape the window uses,
runs the window, optionally a traced stretch, and afterwards works out the
compared outputs again with the plain reference (`portbench.reference`),
which is given the same weights, the same record store and the same draws,
and derives the rest itself.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

from portbench import feed, weights
from portbench.reference import data as ref_data
from portbench.reference import model as ref_model

REFERENCE_ROWS = 256      # rows of a block of the reference's forward


def program_config(conf: dict):
    """The port's `Config` as the configuration file states it."""
    from hop_tpu_torch import config as C
    train = dict(conf["train"], betas=tuple(conf["train"]["betas"]))
    return C.Config(data=C.DataConfig(**conf["data"]), llm=C.LLMConfig(**conf["llm"]),
                    hop=C.HOPConfig(**conf["hop"]), baseline=C.BaselineConfig(**conf["baseline"]),
                    loss=C.LossConfig(**conf["loss"]), train=C.TrainConfig(**train))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in the products and convolutions of what runs inside: off as the
    configurations state; on for the control."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def recorder(trace: bool):
    """torch.profiler's named range where a stretch is traced, else nothing."""
    return torch.profiler.record_function if trace else (lambda name: contextlib.nullcontext())


def fill(net, tensors: dict) -> None:
    """Copy `tensors` into every parameter and buffer of `net`, by name."""
    own = net.state_dict(keep_vars=True)
    if set(own) != set(tensors):
        missing, extra = sorted(set(own) - set(tensors)), sorted(set(tensors) - set(own))
        raise KeyError(f"weights do not match the net: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(tensors[name])


def prefixed(gen: dict, dis: dict) -> dict:
    """One dict of both nets' tensors, keyed 'gen.<name>' and 'dis.<name>'."""
    return {**{f"gen.{k}": v for k, v in gen.items()}, **{f"dis.{k}": v for k, v in dis.items()}}


def norms(tensors: list) -> list:
    if not tensors:
        return []
    return torch.stack([t.float().norm() for t in tensors]).cpu().tolist()


class Driver:
    """What both HOP kinds share: the cell, the seed, the device, the
    records, the weights and the generator net."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.conf, self.t = cell.conf, cell.traffic
        self.B = self.t["batch"]
        self.spans = defaultdict(list)
        self.failed = 0
        self.phases = {}                # set-up's phases: name -> host seconds
        self._mark = time.perf_counter()
        self._tmp = None

    def phase(self, name: str) -> None:
        """Close the set-up phase `name` (after a synchronize)."""
        sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self._mark
        self._mark = now

    def prepare(self, min_windows: int = 0):
        """Precision, the record store and the dataset."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.t.get("cudnn_deterministic"):
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.cfg = program_config(self.conf)
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench_")
        self.records = str(Path(self._tmp.name) / "records")
        n = feed.write_records(self.cfg, self.t["clips"], self.t["clip_seconds"], self.seed,
                               self.records)
        if n < min_windows:
            raise ValueError(f"{n} windows cannot fill a batch of {min_windows}")
        self.ds = feed.open_dataset(self.cfg, self.records)
        self.n_speakers = self.ds.speaker_model.n_words
        self.phase("records, CUDA context")

    def device_batch(self, indices):
        from hop_tpu_torch.cli.common import MODEL_BATCH_KEYS, device_batch
        return device_batch(self.ds.make_batch(indices), self.cfg,
                            keys=MODEL_BATCH_KEYS["AD_LLM"], device=self.device)

    def gen_weights(self, n_speakers: int) -> dict:
        """The generator's tensors, made from the seed on the device."""
        return weights.make(ref_model.generator_specs(self.conf, n_speakers),
                            feed.sub_seed(self.seed, feed.WEIGHTS, 0), self.device)

    def dis_weights(self) -> dict:
        return weights.make(ref_model.discriminator_specs(self.conf),
                            feed.sub_seed(self.seed, feed.WEIGHTS, 1), self.device)

    def generator_net(self):
        from hop_tpu_torch.models.hop import HOPModel
        with torch.device("meta"):
            net = HOPModel(self.cfg, self.n_speakers)
        net = net.to_empty(device=self.device)
        fill(net, self.gen_weights(self.n_speakers))
        return net

    def ref_batch(self, records, indices) -> dict:
        return ref_data.device_batch(ref_data.host_batch(records, indices, self.conf),
                                     self.conf, self.device)

    def calibration_calls(self) -> None:
        """What a reading of the check needs after set-up, with no window."""

    def detail(self, ref: dict, prog: dict = None) -> dict:
        """What calibration prints beside the compared numbers."""
        return {}

    def close(self):
        if self._tmp is not None:
            self._tmp.cleanup()
