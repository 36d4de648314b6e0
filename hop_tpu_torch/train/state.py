"""Train state and optimizers of the HOP GAN (port of hop_tpu/train/state.py).

Adam with betas (0.5, 0.999) and eps 1e-8 for both nets, the generator at
the configured learning rate and the discriminator at lr * dis_lr_scale
(reference run_ted.py:338-346; hop_tpu/train/state.py:25-59 and
train/llm.py:107-114). The reference's OneCycleLR is never stepped, so the
rate is constant. The frozen LLM backbone does not require grad and is
left out of the generator's optimizer (JAX masks it with set_to_zero):
gradients still flow through it into the layers that feed it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


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
