"""The Speech2Gesture LS-GAN train step (port of
hop_tpu/train/speech2gesture.py; reference train_eval/train_speech2gesture.py:5-37).

D: MSE(1, D(target motion)) + MSE(0, D(fake motion)); G: 600 * L1 +
5 * MSE(1, D(fake motion)). One step serves as the warmup and the GAN step
(hop_tpu/cli/train_main.py:159): a generator forward without a graph, the D
update, then the generator's loss against the freshly updated
discriminator, its parameters detached, and the G update. Both nets'
BatchNorm statistics chain through their forwards in that order.

The reference's double difference is kept on purpose: the step passes
first differences ("motion") into a discriminator that takes differences
again, so D scores second differences. The step draws nothing (the
baseline has no stochastic layer); `rng` is taken and ignored.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.parallel.collectives import reduce_metrics
from hop_tpu_torch.train.state import (GANTrainState, frozen_call, gan_train_state,
                                       update_d_then_g)


def motion(poses: torch.Tensor) -> torch.Tensor:
    """First differences along time."""
    return poses[:, 1:] - poses[:, :-1]


def make_s2g_train_step(cfg: Config, generator, disc, mesh=None):
    """Returns (train_step, init_state) over `generator` and `disc`
    (speech2gesture's), both updated in place; train_step(state, batch, rng)
    -> (state, {"loss", "gen", "dis"}). On a rank of `mesh` the gradients
    and the metrics are averaged over the batch group (every term is a
    mean)."""
    loss_cfg = cfg.loss

    def init_state() -> GANTrainState:
        return gan_train_state(cfg, generator, disc, mesh)

    def gen_forward(batch):
        return generator(batch["spectrogram"],
                         batch["target_vec"][:, :cfg.data.n_pre_poses])

    def train_step(state: GANTrainState, batch, rng=None):
        del rng
        target = batch["target_vec"]
        state.begin()

        def dis_loss():
            with torch.no_grad():
                fake = gen_forward(batch)
            dis_real = disc(motion(target))
            dis_fake = disc(motion(fake))
            return torch.mean((1.0 - dis_real) ** 2) + torch.mean(dis_fake ** 2)

        def gen_loss():
            out = gen_forward(batch)
            l1 = loss_cfg.regression_weight * torch.mean(torch.abs(out - target))
            gen = loss_cfg.gan_weight * torch.mean((1.0 - frozen_call(disc, motion(out))) ** 2)
            return l1 + gen, {"loss": l1, "gen": gen}
        state, metrics = update_d_then_g(state, dis_loss, gen_loss)
        return state, reduce_metrics(metrics, mesh and mesh.batch_group)

    return train_step, init_state
