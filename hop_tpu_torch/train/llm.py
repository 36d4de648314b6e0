"""The HOP train steps (port of hop_tpu/train/llm.py): the fused GAN step
(:195-287, the default since `HOPConfig.fused_step=True`) and the
reference's 3-forward step (:116-192, :289-328, `fused_step=False`).

The fused step:
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

The 3-forward step (the reference's train_llm loop, train_llm.py:15-86):
  * warmup: a whole generator forward for the batch's speakers, a second
    whole forward for shuffled speakers (it feeds only detached terms, so
    it runs without a graph), the same generator loss, Adam on the
    generator;
  * GAN: first the D phase, a generator forward of its own (detached, no
    graph), the D term on it with noisy targets, and Adam on the
    discriminator; then the warmup step's generator update with the G term
    against the FRESHLY UPDATED discriminator. gwnet's BatchNorm statistics
    chain through the three generator forwards (D phase, batch's speakers,
    shuffled speakers) and the discriminator's through its three (real,
    fake, G term), in that order (llm.py:13, :301-321).

Randomness. The small draws of a step (the heads' speaker noise, the
speaker permutation, the discriminator's target and fake noise, K1's
dropout seed, the backbone's kernel-attention dropout seed and the seed of
the device generator) come from one CPU
`torch.Generator` per step, in a `StepNoise` record that a step takes, so a
test can hand in JAX's draws instead. The large dropout masks (BERT's, the
discriminator GRU's) come from a device generator seeded from that record;
the 3-forward step's generator forwards seed K1's dropout with
`reprog_seed`, `+ 1` and `+ 2`, and K4's or K5's with `attn_seed` likewise.

On a rank of a parallel run (`mesh`): the draws are those of the GLOBAL
batch (drawn alike on every rank from the step's generator, or handed in),
and the rank takes its rows (`StepNoise.for_rank`): its rows of the speaker
and discriminator noise, the permutation's entries for its rows, which
index the global batch's speaker ids (`parallel.GLOBAL_VIDS`), and the
seeds folded with its block of rows. The optimizers reduce the gradients
over the batch group; the metrics leave the step averaged over it. Every
loss term is a mean over samples, so with equal blocks of rows the averaged
gradient is the global batch's.

`make_hop_train_steps(cfg, model, disc, mesh)` returns (warmup, gan,
init_state), each step an `EpochStep` whose `for_epoch(0)` variant runs the
frozen backbone without dropout (the reference's mode dynamics, see
hop_tpu/train/llm.py:53-71). A step is called as `step(state, batch, rng)`
with `rng` a CPU torch.Generator (the step draws its `StepNoise` from it)
or a `StepNoise`, and returns (state, metrics).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional, Union

import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.models.common import huber, kld_loss
from hop_tpu_torch.parallel.collectives import reduce_metrics
from hop_tpu_torch.parallel.mesh import GLOBAL_VIDS
from hop_tpu_torch.train.state import (GANTrainState, batch_seed, frozen_call,
                                       gan_train_state, update_d_then_g)


@dataclass
class StepNoise:
    """Every random draw of one step but the large dropout masks. The
    trimodal GAN step (train/gan.py) draws the speakers' fields alone
    (`draw_speakers`) and leaves the discriminator's noise and the kernels'
    seeds unset; the hierarchy's step (train/hierarchy.py) draws them with
    one row of speaker noise per cascade stage (`draw_stages`: `eps`,
    `eps_rand` and `eps_dis` then (n_stages, B, z))."""
    eps: torch.Tensor            # (B, z) speaker noise, the batch's speakers
    eps_rand: torch.Tensor       # (B, z) speaker noise, shuffled speakers
    perm: torch.Tensor           # (B,) int64: rand_vids = vids[perm]
    dropout_seed: int            # seeds the device generator of the masks
    # (B, n_poses, pose_dim) N(0, 1), the discriminator's real / fake input
    target_noise: Optional[torch.Tensor] = None
    fake_noise: Optional[torch.Tensor] = None
    reprog_seed: int = 0         # K1's attention-dropout seed
    # (B, z) speaker noise of the 3-forward step's D-phase generator forward
    eps_dis: Optional[torch.Tensor] = None
    # dropout seed of the backbone's kernel attention routes (K4, K5)
    attn_seed: int = 0

    @classmethod
    def draw(cls, generator: torch.Generator, cfg: Config,
             batch_size: int) -> "StepNoise":
        """The draws of one HOP step from a CPU generator, in a fixed order."""
        g = generator
        z, T, P = cfg.hop.z_size, cfg.data.n_poses, cfg.data.pose_dim
        return cls(
            eps=torch.randn(batch_size, z, generator=g),
            eps_rand=torch.randn(batch_size, z, generator=g),
            perm=torch.randperm(batch_size, generator=g),
            target_noise=torch.randn(batch_size, T, P, generator=g),
            fake_noise=torch.randn(batch_size, T, P, generator=g),
            reprog_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)),
            dropout_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)),
            eps_dis=torch.randn(batch_size, z, generator=g),
            # drawn last: every earlier draw keeps its value
            attn_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)))

    @classmethod
    def draw_speakers(cls, generator: torch.Generator, batch_size: int,
                      z_size: int) -> "StepNoise":
        """The draws of one trimodal GAN step from a CPU generator, in a
        fixed order: the speaker noise of its three generator forwards, the
        permutation and the dropout seed."""
        g = generator
        return cls(eps=torch.randn(batch_size, z_size, generator=g),
                   eps_rand=torch.randn(batch_size, z_size, generator=g),
                   perm=torch.randperm(batch_size, generator=g),
                   eps_dis=torch.randn(batch_size, z_size, generator=g),
                   dropout_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)))

    @classmethod
    def draw_stages(cls, generator: torch.Generator, n_stages: int, batch_size: int,
                    z_size: int) -> "StepNoise":
        """The draws of one hierarchy step from a CPU generator, in a fixed
        order: the speaker noise of every stage of its three cascades (the
        batch's speakers, shuffled speakers, the D phase's), the
        permutation and the dropout seed."""
        g = generator
        shape = (n_stages, batch_size, z_size)
        return cls(eps=torch.randn(shape, generator=g),
                   eps_rand=torch.randn(shape, generator=g),
                   perm=torch.randperm(batch_size, generator=g),
                   eps_dis=torch.randn(shape, generator=g),
                   dropout_seed=int(torch.randint(0, 2 ** 31, (1,), generator=g)))

    def for_rank(self, mesh, local_batch: int) -> "StepNoise":
        """This rank's share of a global batch's draws: the rows of its block
        of the noise (the speaker noise's second-to-last axis, the
        discriminator noise's first), the permutation's entries for its rows
        (indices into the global batch), and every seed folded with its
        block. The draws themselves where the batch is not split."""
        if mesh is None or mesh.batch_size == 1:
            return self
        rows = mesh.rows(local_batch)

        def cut(name, t):
            if isinstance(t, int):
                return batch_seed(t, mesh)
            if t is None:
                return None
            return t[..., rows, :] if name.startswith("eps") else t[rows]
        return replace(self, **{f.name: cut(f.name, getattr(self, f.name))
                                for f in fields(self)})

    def to(self, device) -> "StepNoise":
        """The draws on `device`; to a card from pinned memory, without
        making the host wait for it."""
        def put(t):
            if torch.device(device).type == "cuda" and t.device.type == "cpu":
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)
        return replace(self, **{f.name: put(getattr(self, f.name)) for f in fields(self)
                                if isinstance(getattr(self, f.name), torch.Tensor)})


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


def generator_terms(out, out_rand, z, z_rand, mu, logvar, target, loss_cfg,
                    regression: Optional[torch.Tensor] = None):
    """Huber + the diversity regulariser with its clamp + KLD (hop_tpu
    llm.py:126-152, gan.py:65-86): (loss, metrics, (div_raw, pose_l1,
    z_l1)); `out_rand` and `z_rand` enter detached. `regression` replaces
    huber(out, target) (the hierarchy sums one per cascade stage)."""
    h = huber(out, target, loss_cfg.huber_beta) if regression is None else regression
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
               "DIV_REG": div_reg * loss_cfg.reg_weight}
    return loss, metrics, (div_raw, pose_l1, z_l1)


def shuffled_vids(batch, noise: StepNoise) -> torch.Tensor:
    """The shuffled speakers of the diversity regulariser: the permuted
    speaker ids of the global batch (`parallel.GLOBAL_VIDS` on a rank of a
    split batch), at this rank's rows."""
    return batch.get(GLOBAL_VIDS, batch["vid_indices"])[noise.perm]


def gen_term(disc, out, dev_gen, gan_weight: float):
    """The G term -mean(log D(out)) * gan_weight against `disc` held frozen
    (`frozen_call`)."""
    score = frozen_call(disc, out, generator=dev_gen)
    return -torch.mean(torch.log(score + 1e-8)) * gan_weight


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


def make_hop_train_steps(cfg: Config, model, disc, mesh=None):
    """Returns (warmup_step, gan_step, init_state) over `model` (HOPModel)
    and `disc` (ConvDiscriminator), both updated in place: the fused step
    when `cfg.hop.fused_step`, else the 3-forward step; on a rank of `mesh`
    where that is given."""
    loss_cfg = cfg.loss

    def init_state() -> GANTrainState:
        return gan_train_state(cfg, model, disc, mesh)

    def hop_terms(out, out_rand, z, z_rand, mu, logvar, target):
        """`generator_terms` and the diversity regulariser's diagnostics."""
        loss, metrics, div = generator_terms(out, out_rand, z, z_rand, mu, logvar,
                                             target, loss_cfg)
        metrics.update(_div_diagnostics(*div, out, mu, logvar, loss_cfg))
        return loss, metrics

    def dis_loss(fake, target, noise: StepNoise, dev_gen):
        """The D term on a detached sample, noisy targets (train_llm.py:22;
        llm.py:165-176): real forward, then fake."""
        dis_real = disc(target + 0.1 * noise.target_noise, dev_gen)
        dis_fake = disc(fake.detach() + 0.1 * noise.fake_noise, dev_gen)
        return -torch.mean(torch.log(dis_real + 1e-8)
                           + torch.log(1.0 - dis_fake + 1e-8))

    def fused_loss(batch, noise: StepNoise, use_gan: bool, llm_train: bool,
                   dev_gen: torch.Generator):
        target = batch["target_vec"]
        vids = batch["vid_indices"]
        out, out_rand, (z, mu, logvar), z_rand = model.two_speaker_forward(
            batch["in_audio"], batch["log_mel"], batch["text_padded"],
            target[:, :cfg.data.n_seed_frames], vids, shuffled_vids(batch, noise),
            eps=noise.eps, eps_rand=noise.eps_rand, generator=dev_gen,
            reprog_seed=noise.reprog_seed, attn_seed=noise.attn_seed,
            llm_train=llm_train)
        loss, metrics = hop_terms(out, out_rand, z, z_rand, mu, logvar, target)
        if use_gan:
            metrics["gen"] = gen_term(disc, out, dev_gen, loss_cfg.gan_weight)
            metrics["dis"] = dis_loss(out, target, noise, dev_gen)
            loss = loss + metrics["gen"] + metrics["dis"]
        return loss, metrics

    def begin_step(state: GANTrainState, batch, noise: StepNoise):
        device = batch["in_audio"].device
        state.begin()
        return (noise.to(device),
                torch.Generator(device=device).manual_seed(noise.dropout_seed))

    def fused_step(state: GANTrainState, batch, noise: StepNoise,
                   use_gan: bool, llm_train: bool = True):
        """One step with the given draws; returns (state, metrics), the
        metrics detached 0-d tensors on the batch's device."""
        noise, dev_gen = begin_step(state, batch, noise)
        loss, metrics = fused_loss(batch, noise, use_gan, llm_train, dev_gen)
        loss.backward()
        state.gen_opt.step()
        if use_gan:
            state.dis_opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    # ---- the reference's 3-forward step (cfg.hop.fused_step False) --------
    def gen_forward(batch, vids, eps, noise: StepNoise, nth: int,
                    llm_train: bool, dev_gen):
        """The step's `nth` whole generator forward in training mode
        (`_gen_apply`, llm.py:38-50): (out, z, mu, logvar). Its kernels'
        dropout seeds are the step's plus `nth`."""
        return model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                     batch["target_vec"][:, :cfg.data.n_seed_frames], vids,
                     generator=dev_gen, eps=eps,
                     reprog_seed=noise.reprog_seed + nth,
                     attn_seed=noise.attn_seed + nth, llm_train=llm_train)

    def gen_loss(batch, noise: StepNoise, use_gan: bool, llm_train: bool,
                 dev_gen: torch.Generator):
        vids = batch["vid_indices"]
        out, z, mu, logvar = gen_forward(batch, vids, noise.eps, noise, 0,
                                         llm_train, dev_gen)
        # divergent outputs for shuffled speakers (train_llm.py:50-69): this
        # forward feeds only detached terms, so it keeps no graph
        with torch.no_grad():
            out_rand, z_rand, _, _ = gen_forward(
                batch, shuffled_vids(batch, noise), noise.eps_rand, noise, 1, llm_train,
                dev_gen)
        loss, metrics = hop_terms(out, out_rand, z, z_rand, mu, logvar,
                                  batch["target_vec"])
        if use_gan:
            metrics["gen"] = gen_term(disc, out, dev_gen, loss_cfg.gan_weight)
            loss = loss + metrics["gen"]
        return loss, metrics

    def parity_step(state: GANTrainState, batch, noise: StepNoise,
                    use_gan: bool, llm_train: bool = True):
        """One 3-forward step with the given draws; returns (state, metrics)
        as `fused_step` does."""
        if noise.eps_dis is None and use_gan:
            raise ValueError("the 3-forward GAN step needs StepNoise.eps_dis")
        noise, dev_gen = begin_step(state, batch, noise)
        dis_loss_fn = None
        if use_gan:
            def dis_loss_fn():
                # D phase: a generator forward of its own, detached, and the
                # discriminator's update BEFORE the G phase (llm.py:301-317)
                with torch.no_grad():
                    fake = gen_forward(batch, batch["vid_indices"], noise.eps_dis,
                                       noise, 2, llm_train, dev_gen)[0]
                return dis_loss(fake, batch["target_vec"], noise, dev_gen)
        return update_d_then_g(state, dis_loss_fn, lambda: gen_loss(
            batch, noise, use_gan, llm_train, dev_gen))

    run_step = fused_step if cfg.hop.fused_step else parity_step

    def variant(use_gan: bool, llm_train: bool):
        def step(state: GANTrainState, batch,
                 rng: Union[torch.Generator, StepNoise]):
            noise, B = rng, batch["in_audio"].shape[0]
            if isinstance(rng, torch.Generator):
                noise = StepNoise.draw(rng, cfg, B * (mesh.batch_size if mesh else 1))
            state, metrics = run_step(state, batch, noise.for_rank(mesh, B), use_gan,
                                      llm_train)
            return state, reduce_metrics(metrics, mesh and mesh.batch_group)
        return step

    return (EpochStep(variant(False, True), variant(False, False)),
            EpochStep(variant(True, True), variant(True, False)),
            init_state)
