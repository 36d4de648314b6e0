"""The trimodal GAN's train steps (port of hop_tpu/train/gan.py; reference
train_eval/train_gan.py:13-103).

The schema of the HOP step (train/llm.py) on the PoseGenerator and the
ConvDiscriminator: the seed input is the first n_pre_poses target frames
with an indicator bit (`build_pre_seq`), the targets enter the
discriminator without noise, and the GAN gate is the training loop's
`epoch > loss_warmup`.

Warmup step: a generator forward for the batch's speakers, a second one
(no graph: it feeds only detached terms) for shuffled speakers; Huber,
the diversity regulariser with its clamp and KLD; Adam on the generator.

GAN step (hop_tpu gan.py:118-142): first a generator forward of its own
(no graph), the D term -mean(log D(real) + log(1 - D(fake))) and Adam on
the discriminator; then the warmup step's generator update with the G term
-mean(log D(G(x))) against the FRESHLY UPDATED discriminator, its
parameters detached (its BatchNorm statistics still update). The
generator's BatchNorm statistics (the WavEncoder's) chain through its three
forwards, the discriminator's through its three (real, fake, G term), in
that order.

The loss terms, the G term, the state and the D-then-G update are the HOP
step's (`train.llm.generator_terms`, `gen_term`; `train.state`). The small
draws of a step (the speaker noise of each generator forward, the speaker
permutation, the seed of the device generator that draws the dropout
masks) are a `StepNoise` of the speakers' fields
(`StepNoise.draw_speakers`), drawn from the step's CPU generator or handed
in by a test. A step is called as `step(state, batch, rng)` and
returns (state, metrics): "loss", "KLD", "DIV_REG", and in the GAN step
"gen" and "dis", detached 0-d tensors on the batch's device.
"""

from __future__ import annotations

from typing import Union

import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.parallel.collectives import reduce_metrics
from hop_tpu_torch.train.llm import StepNoise, gen_term, generator_terms, shuffled_vids
from hop_tpu_torch.train.state import GANTrainState, gan_train_state, update_d_then_g


def build_pre_seq(target: torch.Tensor, n_pre_poses: int) -> torch.Tensor:
    """(B, T, D) -> (B, T, D + 1): the first n_pre_poses frames and an
    indicator bit set on them, zeros after (train_gan.py:20-22)."""
    B, T, D = target.shape
    pre = target.new_zeros(B, T, D + 1)
    pre[:, :n_pre_poses, :D] = target[:, :n_pre_poses]
    pre[:, :n_pre_poses, D] = 1.0
    return pre


def make_gan_train_steps(cfg: Config, generator, disc, mesh=None):
    """Returns (warmup_step, gan_step, init_state) over `generator`
    (PoseGenerator) and `disc` (ConvDiscriminator), both updated in place;
    on a rank of `mesh` as the HOP step is (train/llm.py)."""
    loss_cfg = cfg.loss

    def init_state() -> GANTrainState:
        return gan_train_state(cfg, generator, disc, mesh)

    def gen_forward(batch, pre_seq, vids, eps, dev_gen):
        return generator(pre_seq, batch["text_padded"], batch["in_audio"], vids,
                         generator=dev_gen, eps=eps)

    def gen_loss(batch, noise: StepNoise, use_gan: bool, dev_gen):
        target, vids = batch["target_vec"], batch["vid_indices"]
        pre_seq = build_pre_seq(target, cfg.data.n_pre_poses)
        out, z, mu, logvar = gen_forward(batch, pre_seq, vids, noise.eps, dev_gen)
        with torch.no_grad():
            out_rand, z_rand, _, _ = gen_forward(batch, pre_seq, shuffled_vids(batch, noise),
                                                 noise.eps_rand, dev_gen)
        loss, metrics, _ = generator_terms(out, out_rand, z, z_rand, mu, logvar, target,
                                           loss_cfg)
        if use_gan:
            metrics["gen"] = gen_term(disc, out, dev_gen, loss_cfg.gan_weight)
            loss = loss + metrics["gen"]
        return loss, metrics

    def run_step(state: GANTrainState, batch, noise: StepNoise, use_gan: bool):
        device = batch["target_vec"].device
        noise = noise.to(device)
        dev_gen = torch.Generator(device=device).manual_seed(noise.dropout_seed)
        state.begin()
        dis_loss = None
        if use_gan:
            def dis_loss():
                target = batch["target_vec"]
                with torch.no_grad():
                    fake = gen_forward(batch, build_pre_seq(target, cfg.data.n_pre_poses),
                                       batch["vid_indices"], noise.eps_dis, dev_gen)[0]
                dis_real = disc(target, dev_gen)
                dis_fake = disc(fake, dev_gen)
                return -torch.mean(torch.log(dis_real + 1e-8)
                                   + torch.log(1.0 - dis_fake + 1e-8))
        return update_d_then_g(state, dis_loss,
                               lambda: gen_loss(batch, noise, use_gan, dev_gen))

    def variant(use_gan: bool):
        def step(state: GANTrainState, batch, rng: Union[torch.Generator, StepNoise]):
            noise, B = rng, batch["target_vec"].shape[0]
            if isinstance(rng, torch.Generator):
                noise = StepNoise.draw_speakers(rng, B * (mesh.batch_size if mesh else 1),
                                                generator.speaker_mu.out_features)
            state, metrics = run_step(state, batch, noise.for_rank(mesh, B), use_gan)
            return state, reduce_metrics(metrics, mesh and mesh.batch_group)
        return step

    return variant(False), variant(True), init_state
