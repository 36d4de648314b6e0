"""`train_gan`: HOP's fused GAN step (`train.llm.make_hop_train_steps`),
closed loop, its batches made and moved by the port's input path
(`make_batch` from the record store, `cli.common.device_batch`) in turn or
on `train.loops.prefetch_iter`'s thread up to `prefetch` ahead.

Traffic keys: `batch`, `prefetch`, `clips`, `clip_seconds` (the record
store), `epoch` (the GAN step of that epoch), `log_every` (metrics fetched
every so many steps), `trace_steps`, `cudnn_deterministic`.

The first `COMPARED_STEPS` steps are the set-up's warm-up: they go through
the window's own feed and call, on batches whose rows all differ, and the
readings of the check are taken from them (`check.train_numbers`).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, feed, hop
from portbench.reference import data as ref_data

LOSS_TERMS = ("loss", "KLD", "DIV_REG", "gen", "dis")
COMPARED_STEPS = 3        # the steps that the check compares


class Driver(hop.Driver):
    kind = "train_gan"

    def setup(self):
        from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
        from hop_tpu_torch.train import llm
        from hop_tpu_torch.train.loops import prefetch_iter
        self.prepare(min_windows=self.B)
        cfg = self.cfg
        self.model = self.generator_net()
        self.phase("generator")
        with torch.device("meta"):
            disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses, cfg.hop.gru_kernel,
                                     cfg.hop.gru_bf16_streams)
        self.disc = disc.to_empty(device=self.device)
        hop.fill(self.disc, self.dis_weights())
        _, gan, init_state = llm.make_hop_train_steps(cfg, self.model, self.disc)
        self.state = init_state()
        self.step_fn = gan.for_epoch(self.t["epoch"])
        self.recording = False
        self.source = prefetch_iter(self.produce(feed.epoch_batches(self.seed, len(self.ds),
                                                                    self.B)),
                                    self.t["prefetch"])
        self.k = 0
        self.phase("discriminator, optimizers, feed")
        self.compared()
        self.phase("compared steps")

    def produce(self, order):
        """(indices, batch) in order; while the window is open each batch's
        host time to make and move it is a `device_batch` span (taken on
        the feed's thread where it runs ahead)."""
        for idx in order:
            a = time.perf_counter()
            batch = self.device_batch(idx)
            if self.recording:
                self.spans["device_batch"].append(time.perf_counter() - a)
            yield idx, batch

    def step(self, batch):
        self.state, metrics = self.step_fn(self.state, batch, feed.step_rng(self.seed, self.k))
        self.k += 1
        return metrics

    def leaves(self):
        out = [(f"gen.{n}", p) for n, p in self.model.named_parameters() if p.requires_grad]
        return out + [(f"dis.{n}", p) for n, p in self.disc.named_parameters()]

    def compared(self):
        """The first steps, through the window's feed and call: the check's
        readings of the port."""
        losses, self.used = [], []
        for j in range(COMPARED_STEPS):
            idx, batch = next(self.source)
            self.used.append(idx)
            metrics = self.step(batch)
            losses.append(dict(zip(LOSS_TERMS, torch.stack(
                [metrics[k].float() for k in LOSS_TERMS]).cpu().tolist())))
            if j == 0:     # Adam's first moment after one step is (1 - beta1) g
                opts = {"gen": self.state.gen_opt, "dis": self.state.dis_opt}
                moments = {n: opts[n[:3]].state[p]["exp_avg"] for n, p in self.leaves()
                           if "exp_avg" in opts[n[:3]].state.get(p, {})}
                scale = 1.0 / (1.0 - self.cfg.train.betas[0])
                grad = {n: v * scale for n, v in zip(moments, hop.norms(list(moments.values())))}
        start = hop.prefixed(self.gen_weights(self.n_speakers), self.dis_weights())
        names, now = zip(*self.leaves())
        change = dict(zip(names, hop.norms([p.detach() - start[n] for n, p in zip(names, now)])))
        del start
        self.readings = {"losses": losses, "grad": grad, "change": change}

    def _drain(self, pending: list):
        if not pending:
            return
        vals = torch.stack([m["loss"].float() for m in pending]).cpu().tolist()
        self.failed += sum(1 for v in vals if not np.isfinite(v))
        pending.clear()

    def loop(self, until, spans: bool, trace: bool):
        """Steps until `until(n)`; metrics fetched every `log_every` steps."""
        pending, n = [], 0
        rec = hop.recorder(trace)
        self.recording = spans
        while not until(n):
            with rec("portbench.batch_wait"):
                _, batch = next(self.source)
            a = time.perf_counter()
            with rec("portbench.step"):
                pending.append(self.step(batch))
            if spans:
                self.spans["step"].append(time.perf_counter() - a)
            n += 1
            if n % self.t["log_every"] == 0:
                self._drain(pending)
        self.recording = False
        self._drain(pending)
        return n

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"train_samples_per_s": units * self.B / window_s}

    def release(self):
        self.stop_feed()
        del self.state, self.step_fn, self.model, self.disc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> dict:
        """The reference's readings of the compared steps (in TF32 for the
        control)."""
        from portbench.reference import train as ref_train
        records = ref_data.Records(self.records, self.conf)
        gen, dis = self.gen_weights(records.n_speakers()), self.dis_weights()
        gan = ref_train.GANStep(self.conf, gen, dis)
        losses = []
        with hop.tf32(control):
            for j, idx in enumerate(self.used):
                batch = self.ref_batch(records, idx)
                losses.append(gan(batch, ref_train.draw_noise(feed.step_rng(self.seed, j),
                                                              self.conf, len(idx))))
                if j == 0:
                    g = gan.grads()
                    grad = dict(zip(g, hop.norms(list(g.values()))))
        start = hop.prefixed(gen, dis)
        now = gan.tensors()
        change = dict(zip(now, hop.norms([now[k].detach() - start[k] for k in now])))
        return {"losses": losses, "grad": grad, "change": change}

    def numbers(self, ref: dict, prog: dict = None) -> dict:
        return check.train_numbers(prog or self.readings, ref)

    def detail(self, ref: dict, prog: dict = None) -> dict:
        """Each step's loss terms, and each compared leaf's two norms."""
        prog = prog or self.readings
        kept = check.moved_leaves(ref["grad"])
        return {"loss_terms": check.loss_detail(prog["losses"], ref["losses"]),
                **{part: {k: [prog[part].get(k, 0.0), ref[part][k]] for k in kept}
                   for part in ("grad", "change")}}

    def stop_feed(self):
        if getattr(self, "source", None) is not None:
            self.source.close()
            self.source = None

    def close(self):
        self.stop_feed()
        super().close()
