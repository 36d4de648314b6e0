"""The seq2seq baseline's train step (port of hop_tpu/train/seq2seq.py;
reference train_eval/train_seq2seq.py:6-51).

custom_loss = 600 * MSE + kld_weight * the continuity term (the sum of
|frame t+1 - frame t| over the number of elements) - reg_weight * the norm
of each joint's motion over time, summed over the number of elements.
Adam after a clip of the gradients' global norm at
`cfg.train.grad_clip_seq2seq` (5). There is no GAN step. The step's only
draws are the encoder's dropout masks, from a device generator seeded from
the step's `rng` (a CPU generator, or an int).

On a rank of a parallel run (`mesh`) the gradients are averaged over the
batch group BEFORE the clip (the global norm is the global batch's), the
decoder's `BatchStatNorm` reads the global batch's statistics
(`parallel.attach_batch_group`), and the dropout seed is folded with the
rank's block of rows.
"""

from __future__ import annotations

import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.parallel.collectives import reduce_metrics
from hop_tpu_torch.train.state import (SimpleTrainState, adam, clip_grad_global_norm_,
                                       dropout_generator, reduce_grads)


def custom_loss(output: torch.Tensor, target: torch.Tensor, cfg: Config) -> torch.Tensor:
    n_element = output.numel()
    mse = torch.mean((output - target) ** 2) * cfg.loss.regression_weight
    cont = torch.sum(torch.abs(output[:, 1:] - output[:, :-1])) / n_element
    cont = cont * cfg.loss.kld_weight
    norm = torch.linalg.vector_norm(output, dim=1)      # over time (torch dim=1)
    var = -torch.sum(norm) / n_element * cfg.loss.reg_weight
    return mse + cont + var


def make_seq2seq_train_step(cfg: Config, net, mesh=None):
    """Returns (train_step, init_state) over `net` (Seq2SeqNet), updated in
    place; train_step(state, batch, rng) -> (state, {"loss": ...})."""

    def init_state() -> SimpleTrainState:
        return SimpleTrainState(net, adam(net, cfg.train.learning_rate, cfg.train.betas,
                                          mesh))

    def train_step(state: SimpleTrainState, batch, rng):
        target = batch["target_vec"]
        net.train()
        state.opt.zero_grad(set_to_none=True)
        out = net(batch["word_seq"], batch["text_mask"], target,
                  generator=dropout_generator(rng, target.device, mesh))
        loss = custom_loss(out, target, cfg)
        loss.backward()
        reduce_grads(state.opt)
        clip_grad_global_norm_(net, cfg.train.grad_clip_seq2seq)
        state.opt.step()
        state.step += 1
        return state, reduce_metrics({"loss": loss.detach()}, mesh and mesh.batch_group)

    return train_step, init_state
