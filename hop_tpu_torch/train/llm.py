"""The fused HOP GAN train step (port of hop_tpu/train/llm.py:195-287, the
default since `HOPConfig.fused_step=True`).

One step, as in the JAX fused path:
  * `HOPModel.two_speaker_forward`: the trunk once, the head for the
    batch's speakers and (detached, no graph) for shuffled ones;
  * the generator loss: Huber, the diversity regulariser with its clamp,
    KLD (llm.py:211-236), and in the GAN variant the G term against the
    current discriminator held frozen (its parameters enter detached, so no
    G-term gradient reaches them);
  * in the GAN variant the D term on the detached sample with noisy targets
    (llm.py:165-176, 248-253). The discriminator's BatchNorm statistics
    chain through its three forwards in JAX's order: G term, real, fake;
  * one backward over the sum, then Adam on the generator (frozen backbone
    excluded) and, in the GAN variant, on the discriminator.

Randomness. The small draws of a step (both heads' speaker noise, the
speaker permutation, the discriminator's target and fake noise, K1's
dropout seed and the seed of the device generator) come from one CPU
`torch.Generator` per step, in a `StepNoise` record that `fused_step`
takes, so a test can hand in JAX's draws instead. The large dropout masks
(BERT's, the discriminator GRU's) come from a device generator seeded
from that record.

`make_hop_train_steps(cfg, model, disc)` returns (warmup, gan,
init_state), each step an `EpochStep` whose `for_epoch(0)` variant runs the
frozen backbone without dropout (the reference's mode dynamics, see
hop_tpu/train/llm.py:53-71). A step is called as `step(state, batch, rng)`
with `rng` a CPU torch.Generator (the step draws its `StepNoise` from it)
or a `StepNoise`, and returns (state, metrics).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Union

import torch
from torch.func import functional_call

from hop_tpu_torch.config import Config
from hop_tpu_torch.models.common import huber, kld_loss
from hop_tpu_torch.train.state import GANTrainState, adam


@dataclass
class StepNoise:
    """Every random draw of one step but the large dropout masks."""
    eps: torch.Tensor            # (B, z) speaker noise, the batch's speakers
    eps_rand: torch.Tensor       # (B, z) speaker noise, shuffled speakers
    perm: torch.Tensor           # (B,) int64: rand_vids = vids[perm]
    target_noise: torch.Tensor   # (B, n_poses, pose_dim) N(0, 1), real input
    fake_noise: torch.Tensor     # (B, n_poses, pose_dim) N(0, 1), fake input
    reprog_seed: int             # K1's attention-dropout seed
    dropout_seed: int            # seeds the device generator of the masks

    @classmethod
    def draw(cls, generator: torch.Generator, cfg: Config,
             batch_size: int) -> "StepNoise":
        """The draws of one step from a CPU generator, in a fixed order."""
        g = generator
        z, T, P = cfg.hop.z_size, cfg.data.n_poses, cfg.data.pose_dim
        return cls(
            eps=torch.randn(batch_size, z, generator=g),
            eps_rand=torch.randn(batch_size, z, generator=g),
            perm=torch.randperm(batch_size, generator=g),
            target_noise=torch.randn(batch_size, T, P, generator=g),
            fake_noise=torch.randn(batch_size, T, P, generator=g),
            reprog_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)),
            dropout_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)))

    def to(self, device) -> "StepNoise":
        return replace(self, **{k: getattr(self, k).to(device) for k in
                                ("eps", "eps_rand", "perm", "target_noise",
                                 "fake_noise")})


def _div_diagnostics(div_raw, pose_l1, z_l1, out, mu, logvar, loss_cfg):
    """Observability scalars of the diversity regulariser (JAX llm.py:74-90),
    all detached."""
    return {
        "div_raw": div_raw.detach().mean(),
        "div_clamp_frac": (div_raw.detach() <= loss_cfg.div_clamp).float().mean(),
        "div_pose_l1": pose_l1.detach().mean(),
        "div_z_l1": z_l1.detach().mean(),
        "out_abs": out.detach().abs().mean(),
        "mu_abs": mu.detach().abs().mean(),
        "logvar_mean": logvar.detach().mean(),
    }


class EpochStep:
    """A train step whose variant depends on the epoch: epoch 0 runs the
    frozen backbone without dropout, later epochs with it (JAX
    llm.py:53-71). Calling the step directly uses the steady variant."""

    def __init__(self, steady: Callable, epoch0: Callable):
        self._steady, self._epoch0 = steady, epoch0

    def __call__(self, state, batch, rng):
        return self._steady(state, batch, rng)

    def for_epoch(self, epoch: int) -> Callable:
        return self._epoch0 if epoch == 0 else self._steady


def make_hop_train_steps(cfg: Config, model, disc):
    """Returns (warmup_step, gan_step, init_state) over `model` (HOPModel)
    and `disc` (ConvDiscriminator), both updated in place."""
    loss_cfg = cfg.loss

    def init_state() -> GANTrainState:
        t = cfg.train
        return GANTrainState(model, disc,
                             adam(model, t.learning_rate, t.betas),
                             adam(disc, t.learning_rate * t.dis_lr_scale, t.betas))

    def fused_loss(batch, noise: StepNoise, use_gan: bool, llm_train: bool,
                   dev_gen: torch.Generator):
        target = batch["target_vec"]
        vids = batch["vid_indices"]
        out, out_rand, (z, mu, logvar), z_rand = model.two_speaker_forward(
            batch["in_audio"], batch["log_mel"], batch["text_padded"],
            target[:, :cfg.data.n_seed_frames], vids, vids[noise.perm],
            eps=noise.eps, eps_rand=noise.eps_rand, generator=dev_gen,
            reprog_seed=noise.reprog_seed, llm_train=llm_train)

        h = huber(out, target, loss_cfg.huber_beta)
        pose_l1 = huber(out, out_rand.detach(), loss_cfg.div_beta,
                        reduce=False).sum(dim=(1, 2))
        z_l1 = torch.mean(torch.abs(z.detach() - z_rand.detach()), dim=-1)
        div_raw = -(pose_l1 / (z_l1 + 1e-5))
        div_reg = torch.clamp(div_raw, min=loss_cfg.div_clamp).mean()
        kld = kld_loss(mu, logvar)
        loss = (h * loss_cfg.regression_weight
                + div_reg * loss_cfg.reg_weight
                + kld * loss_cfg.kld_weight)
        metrics = {"loss": h * loss_cfg.regression_weight,
                   "KLD": kld * loss_cfg.kld_weight,
                   "DIV_REG": div_reg * loss_cfg.reg_weight,
                   **_div_diagnostics(div_raw, pose_l1, z_l1, out, mu, logvar,
                                      loss_cfg)}
        if use_gan:
            # G term against the current discriminator, its parameters
            # detached (its BatchNorm statistics still update)
            frozen = {k: p.detach() for k, p in disc.named_parameters()}
            dis_out = functional_call(disc, frozen, (out,),
                                      {"generator": dev_gen})
            gen_error = -torch.mean(torch.log(dis_out + 1e-8))
            loss = loss + gen_error * loss_cfg.gan_weight
            metrics["gen"] = gen_error * loss_cfg.gan_weight

            # D term on the detached sample, noisy targets (train_llm.py:22)
            dis_real = disc(target + 0.1 * noise.target_noise, dev_gen)
            dis_fake = disc(out.detach() + 0.1 * noise.fake_noise, dev_gen)
            dis_err = -torch.mean(torch.log(dis_real + 1e-8)
                                  + torch.log(1.0 - dis_fake + 1e-8))
            loss = loss + dis_err
            metrics["dis"] = dis_err
        return loss, metrics

    def fused_step(state: GANTrainState, batch, noise: StepNoise,
                   use_gan: bool, llm_train: bool = True):
        """One step with the given draws; returns (state, metrics), the
        metrics detached 0-d tensors on the batch's device."""
        device = batch["in_audio"].device
        model.train()
        disc.train()
        dev_gen = torch.Generator(device=device).manual_seed(noise.dropout_seed)
        state.gen_opt.zero_grad(set_to_none=True)
        state.dis_opt.zero_grad(set_to_none=True)
        loss, metrics = fused_loss(batch, noise.to(device), use_gan, llm_train,
                                   dev_gen)
        loss.backward()
        state.gen_opt.step()
        if use_gan:
            state.dis_opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def variant(use_gan: bool, llm_train: bool):
        def step(state: GANTrainState, batch,
                 rng: Union[torch.Generator, StepNoise]):
            noise = rng
            if isinstance(rng, torch.Generator):
                noise = StepNoise.draw(rng, cfg, batch["in_audio"].shape[0])
            return fused_step(state, batch, noise, use_gan, llm_train)
        return step

    return (EpochStep(variant(False, True), variant(False, False)),
            EpochStep(variant(True, True), variant(True, False)),
            init_state)
