"""Train states and optimizers (port of hop_tpu/train/state.py): the GAN
state of HOP, the trimodal GAN and speech2gesture, and the one-net state of
seq2seq and the embedding nets.

Adam with betas (0.5, 0.999) and eps 1e-8 for both nets, the generator at
the configured learning rate and the discriminator at lr * dis_lr_scale
(reference run_ted.py:338-346; hop_tpu/train/state.py:25-59 and
train/llm.py:107-114). The reference's OneCycleLR is never stepped, so the
rate is constant. The frozen LLM backbone does not require grad and is
left out of the generator's optimizer (JAX masks it with set_to_zero):
gradients still flow through it into the layers that feed it.

`gan_train_state` builds the GAN state; `update_d_then_g` is the GAN
steps' update of the discriminator before the generator, whose G term
reads it through `frozen_call`.

`SimpleTrainState` holds one net and its optimizer (hop_tpu's
`SimpleTrainState`, state.py:91-106); seq2seq clips the gradients' global
norm before its Adam step (`clip_grad_global_norm_`, optax's
`clip_by_global_norm`). `dropout_generator` seeds the device generator of a
step's dropout masks from the step's CPU generator.

On a rank of a parallel run (`mesh` given) the optimizers are
`parallel.zero.RankAdam`s: each step first reduces the gradients over the
batch group, and with ZeRO each data rank holds its share of the moments;
their state_dict is the one-process format all the same.

`GANTrainState.state_dict()` is what a checkpoint holds: both nets'
state_dicts (the generator's without the frozen backbone), both
optimizers' (Adam's moments and per-parameter step counts) and the step
count. `load_state_dict` puts it back into a state built by `init_state()`
for the same config and seed, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.func import functional_call

from hop_tpu_torch.ops.dropout import fold_seed
from hop_tpu_torch.parallel.zero import rank_adam
from hop_tpu_torch.utils.checkpoint import reattach_frozen, strip_frozen


def adam(module: nn.Module, lr: float, betas=(0.5, 0.999), mesh=None, op: str = "mean"):
    """Adam over the parameters of `module` that require grad; on a rank of
    `mesh` its gradients reduced over the batch group first (`op` "mean",
    or "sum" for a loss that sums over the batch)."""
    params = [p for p in module.parameters() if p.requires_grad]
    return rank_adam(params, lr, betas, mesh, op)


def reduce_grads(opt) -> None:
    """The gradients of `opt`'s parameters reduced over the batch group now,
    before its step (a no-op for a one-process run's torch Adam)."""
    if hasattr(opt, "sync_grads"):
        opt.sync_grads()


@dataclass
class GANTrainState:
    """Both nets (updated in place by the step), their optimizers, and the
    number of steps taken."""
    model: nn.Module
    disc: nn.Module
    gen_opt: torch.optim.Optimizer
    dis_opt: torch.optim.Optimizer
    step: int = 0

    def begin(self) -> None:
        """A step's start: both nets in training mode, no gradients."""
        self.model.train()
        self.disc.train()
        self.gen_opt.zero_grad(set_to_none=True)
        self.dis_opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"gen": strip_frozen(self.model.state_dict())[0],
                "dis": self.disc.state_dict(),
                "gen_opt": self.gen_opt.state_dict(),
                "dis_opt": self.dis_opt.state_dict(),
                "step": self.step}

    def load_state_dict(self, saved: dict) -> None:
        """Restore `saved` (from `state_dict`, tensors on any device) into
        this state; the frozen backbone stays as built. The optimizers map
        their state by parameter order, so the nets must be built from the
        same config."""
        frozen = strip_frozen(self.model.state_dict())[1]
        self.model.load_state_dict(reattach_frozen(saved["gen"], frozen), strict=True)
        self.disc.load_state_dict(saved["dis"], strict=True)
        self.gen_opt.load_state_dict(saved["gen_opt"])
        self.dis_opt.load_state_dict(saved["dis_opt"])
        self.step = int(saved["step"])


def gan_train_state(cfg, generator: nn.Module, disc: nn.Module, mesh=None) -> GANTrainState:
    """Both nets with their Adams: the generator's at cfg.train's learning
    rate, the discriminator's at that rate times dis_lr_scale."""
    t = cfg.train
    return GANTrainState(generator, disc, adam(generator, t.learning_rate, t.betas, mesh),
                         adam(disc, t.learning_rate * t.dis_lr_scale, t.betas, mesh))


def frozen_call(net: nn.Module, *args, **kwargs):
    """net(*args, **kwargs) with its parameters detached: no gradient reaches
    them (the G term's discriminator); its BatchNorm statistics still
    update."""
    frozen = {k: p.detach() for k, p in net.named_parameters()}
    return functional_call(net, frozen, args, kwargs)


def update_d_then_g(state: GANTrainState, dis_loss: Optional[Callable],
                    gen_loss: Callable):
    """The D phase before the G phase (reference train_gan.py,
    train_llm.py): dis_loss()'s backward and the discriminator's Adam step,
    then gen_loss() -> (loss, metrics), its backward and the generator's
    Adam step, so that a G term reads the freshly updated discriminator.
    dis_loss None: the G phase alone. Returns (state, metrics) with "dis"
    added, all detached."""
    dis_err = None
    if dis_loss is not None:
        dis_err = dis_loss()
        dis_err.backward()
        state.dis_opt.step()
    loss, metrics = gen_loss()
    loss.backward()
    state.gen_opt.step()
    if dis_err is not None:
        metrics["dis"] = dis_err
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


@dataclass
class SimpleTrainState:
    """One net (updated in place by the step), its optimizer, and the number
    of steps taken."""
    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"net": self.model.state_dict(), "opt": self.opt.state_dict(),
                "step": self.step}

    def load_state_dict(self, saved: dict) -> None:
        """Restore `saved` (from `state_dict`) into a state built for the same
        config."""
        self.model.load_state_dict(saved["net"], strict=True)
        self.opt.load_state_dict(saved["opt"])
        self.step = int(saved["step"])


def clip_grad_global_norm_(module: nn.Module, max_norm: float) -> None:
    """Scale the gradients of `module` by max_norm / ||g|| when their global
    norm reaches max_norm (optax.clip_by_global_norm; torch's
    clip_grad_norm_ adds 1e-6 to the norm). No wait for the device."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def dropout_generator(rng: Union[torch.Generator, int],
                      device: torch.device | str, mesh=None) -> torch.Generator:
    """A generator on `device` for a step's dropout masks, seeded with `rng`
    (an int) or with one draw from `rng` (a CPU generator); on a rank of a
    split batch that seed folded with the rank's block of rows, so that the
    ranks draw different masks."""
    seed = rng
    if isinstance(rng, torch.Generator):
        seed = int(torch.randint(0, 2 ** 31, (1,), generator=rng))
    return torch.Generator(device=device).manual_seed(batch_seed(seed, mesh))


def batch_seed(seed: int, mesh) -> int:
    """`seed` folded with the rank's block of rows where the batch is split
    over more than one rank, else `seed`."""
    if mesh is None or mesh.batch_size == 1:
        return seed
    return fold_seed(seed, mesh.batch_rank)
