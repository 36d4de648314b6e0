"""The joint-embedding / gesture-autoencoder train steps (port of
hop_tpu/train/embed.py; reference train_eval/train_joint_embed.py:5-62).

`make_embed_train_step` trains an EmbeddingNet on its poses' reconstruction:
L1 averaged over each sample and summed over the batch, the latent the pose
encoder's mean (the reference hardcodes variational_encoding=False). In
joint-embedding mode the context encoder runs too (its BatchNorm statistics
update) though its latent feeds no loss, as in hop_tpu.
`make_motion_ae_train_step` trains the expressive MotionAE: the
reconstruction's L1 plus the L1 of its first differences, per sample,
summed. Adam at the configured rate for both. The steps' only draws are
the dropout masks, from a device generator seeded from the step's `rng`.

On a rank of a parallel run (`mesh`) both losses sum over the batch, so
the gradients and the logged loss are SUMMED over the batch group, and
the dropout seed is folded with the rank's block of rows.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.parallel.collectives import reduce_metrics
from hop_tpu_torch.train.state import SimpleTrainState, adam, dropout_generator


def make_embed_train_step(cfg: Config, net, mode: str = "pose", mesh=None):
    """Returns (train_step, init_state) over `net` (EmbeddingNet), decoding
    from `mode`'s latent; train_step(state, batch, rng) -> (state, {"loss"})."""

    def init_state() -> SimpleTrainState:
        return SimpleTrainState(net, adam(net, cfg.train.learning_rate, cfg.train.betas,
                                          mesh, op="sum"))

    def train_step(state: SimpleTrainState, batch, rng):
        target = batch["target_vec"]
        net.train()
        state.opt.zero_grad(set_to_none=True)
        recon = net(batch.get("text_padded"), batch.get("in_audio"),
                    target[:, :cfg.data.n_pre_poses], target, input_mode=mode,
                    generator=dropout_generator(rng, target.device, mesh))[-1]
        loss = torch.sum(torch.mean(torch.abs(recon - target), dim=(1, 2)))
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, reduce_metrics({"loss": loss.detach()}, mesh and mesh.batch_group,
                                     "sum")

    return train_step, init_state


def make_motion_ae_train_step(cfg: Config, net, mesh=None):
    """Returns (train_step, init_state) over `net` (MotionAE)."""

    def init_state() -> SimpleTrainState:
        return SimpleTrainState(net, adam(net, cfg.train.learning_rate, cfg.train.betas,
                                          mesh, op="sum"))

    def train_step(state: SimpleTrainState, batch, rng=None):
        del rng
        target = batch["target_vec"]
        net.train()
        state.opt.zero_grad(set_to_none=True)
        recon, _ = net(target)
        l1 = torch.mean(torch.abs(recon - target), dim=(1, 2))
        diff = (recon[:, 1:] - recon[:, :-1]) - (target[:, 1:] - target[:, :-1])
        loss = torch.sum(l1 + torch.mean(torch.abs(diff), dim=(1, 2)))
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, reduce_metrics({"loss": loss.detach()}, mesh and mesh.batch_group,
                                     "sum")

    return train_step, init_state
