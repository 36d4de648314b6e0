"""Train state and optimizers of the HOP GAN (port of hop_tpu/train/state.py).

Adam with betas (0.5, 0.999) and eps 1e-8 for both nets, the generator at
the configured learning rate and the discriminator at lr * dis_lr_scale
(reference run_ted.py:338-346; hop_tpu/train/state.py:25-59 and
train/llm.py:107-114). The reference's OneCycleLR is never stepped, so the
rate is constant. The frozen LLM backbone does not require grad and is
left out of the generator's optimizer (JAX masks it with set_to_zero):
gradients still flow through it into the layers that feed it.

`GANTrainState.state_dict()` is what a checkpoint holds: both nets'
state_dicts (the generator's without the frozen backbone), both
optimizers' (Adam's moments and per-parameter step counts) and the step
count. `load_state_dict` puts it back into a state built by `init_state()`
for the same config and seed, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from hop_tpu_torch.utils.checkpoint import reattach_frozen, strip_frozen


def adam(module: nn.Module, lr: float, betas=(0.5, 0.999)) -> torch.optim.Adam:
    """Adam over the parameters of `module` that require grad."""
    params = [p for p in module.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)


@dataclass
class GANTrainState:
    """Both nets (updated in place by the step), their optimizers, and the
    number of steps taken."""
    model: nn.Module
    disc: nn.Module
    gen_opt: torch.optim.Optimizer
    dis_opt: torch.optim.Optimizer
    step: int = 0

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
