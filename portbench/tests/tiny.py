"""Tiny cells that run the whole harness on the CPU."""

from __future__ import annotations

import dataclasses

TRAIN_TRAFFIC = dict(kind="train_gan", batch=4, prefetch=0, clips=1, clip_seconds=20.0,
                     epoch=11, log_every=2, trace_steps=2, cudnn_deterministic=True)
GEN_TRAFFIC = dict(kind="generate", batch=6, pool=2, clips=1, clip_seconds=20.0, samples=2,
                   sample_from=3, trace_steps=2)
# limits of the tiny cells with an f32 backbone, where the port's plain
# versions and the reference agree to round-off (1e-6 and below)
TINY_LIMITS = {"train_gan": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3},
               "generate": {"pose_gap": 1e-4}}


def tiny_conf(dataset: str = "TED", bf16: bool = False) -> dict:
    """A configuration file's contents for `tiny_test_config`."""
    from hop_tpu_torch import config
    from hop_tpu_torch.models.hop import gru_input_size
    cfg = config.tiny_test_config(dataset)
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=bf16))
    d = dataclasses.asdict(cfg)
    d["train"]["betas"] = list(d["train"]["betas"])
    d["derived"] = {"pose_dim": cfg.data.pose_dim, "n_joints_graph": cfg.data.n_joints_graph,
                    "gru_input_size": gru_input_size(cfg)}
    return d


def tiny_cell(kind: str, dataset: str = "TED", **traffic):
    """A cell of `kind` at tiny widths, with the real cell's metrics."""
    from portbench import cells
    real = cells.load_cell("hop_expressive.train_gan_b256" if kind == "train_gan"
                           else "hop_ted.generate_b1024")
    t = dict(TRAIN_TRAFFIC if kind == "train_gan" else GEN_TRAFFIC, **traffic)
    return cells.Cell(real.name, tiny_conf(dataset), t, dict(TINY_LIMITS[kind]),
                      real.end_to_end, real.per_layer)
