"""`generate`: HOP's evaluation-mode forward under `inference_mode`, as
`infer.make_forward` calls it, closed loop over a pool of distinct batches
staged on the card at set-up.

Traffic keys: `batch`, `pool` (batches staged), `clips`, `clip_seconds`
(the record store), `samples` (calls whose poses are compared, drawn from
the seed among the first `sample_from`; the window's last call is
compared too), `trace_steps`, `cudnn_deterministic`.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import feed, hop
from portbench.reference import data as ref_data
from portbench.reference import model as ref_model


class Driver(hop.Driver):
    kind = "generate"

    def setup(self):
        from hop_tpu_torch.infer import make_forward
        self.prepare()
        self.model = self.generator_net().eval()
        self.phase("generator")
        self.forward = make_forward(self.model)
        self.indices = feed.drawn_batches(self.seed, len(self.ds), self.B, self.t["pool"])
        self.pool = [self.device_batch(idx) for idx in self.indices]
        self.phase("batches")
        warm = torch.Generator(device=self.device).manual_seed(0)
        for _ in range(2):
            self.call(self.pool[0], warm)
        self.gen_seed = feed.sub_seed(self.seed, feed.SAMPLES, 0)
        self.generator = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        rng = np.random.default_rng(feed.sub_seed(self.seed, feed.SAMPLES, 1))
        self.sample = set(rng.choice(self.t["sample_from"], self.t["samples"], replace=False).tolist())
        self.kept, self.k = {}, 0
        self.phase("warm-up calls")

    def call(self, b, generator):
        seed_frames = self.cfg.data.n_seed_frames
        return self.forward(b["in_audio"], b["log_mel"], b["text_padded"],
                            b["target_vec"][:, :seed_frames], b["vid_indices"], generator)

    def loop(self, until, spans: bool, trace: bool):
        n, last = 0, None
        rec = hop.recorder(trace)
        while not until(n):
            b = self.pool[self.k % len(self.pool)]
            a = time.perf_counter()
            with rec("portbench.forward"):
                out = self.call(b, self.generator)
            if spans:
                self.spans["forward"].append(time.perf_counter() - a)
            if self.k in self.sample:
                self.kept[self.k] = out
            last = (self.k, out)
            self.k += 1
            n += 1
        if last is not None and not trace:
            self.kept[last[0]] = last[1]
        return n

    def calibration_calls(self) -> None:
        self.loop(lambda n: n > self.t["sample_from"], spans=False, trace=False)

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"gen_windows_per_s": units * self.B / window_s}

    def release(self):
        self.kept = {k: v.float().cpu() for k, v in self.kept.items()}
        del self.model, self.forward, self.pool
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> dict:
        """The reference's poses of the kept calls, in blocks of rows."""
        records = ref_data.Records(self.records, self.conf)
        gen = self.gen_weights(records.n_speakers())
        g = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        z = self.conf["hop"]["z_size"]
        eps = {}
        for k in range(max(self.kept) + 1):
            e = torch.randn((self.B, z), generator=g, device=self.device)
            if k in self.kept:
                eps[k] = e
        out = {}
        rows = hop.REFERENCE_ROWS
        with hop.tf32(control), torch.no_grad():
            for k in sorted(self.kept):
                batch = self.ref_batch(records, self.indices[k % len(self.indices)])
                parts = []
                for r in range(0, self.B, rows):
                    part = {n: v[r:r + rows] for n, v in batch.items()}
                    parts.append(ref_model.generate(gen, self.conf, part, eps[k][r:r + rows]).cpu())
                out[k] = torch.cat(parts)
        return out

    def numbers(self, ref: dict, prog: dict = None) -> dict:
        prog = prog or self.kept
        return {"pose_gap": max(float((prog[k] - ref[k]).abs().max()) for k in ref)}
