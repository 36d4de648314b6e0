"""HOP's fused GAN step in plain PyTorch (reference train_llm.py with the
generator's trunk shared by its two speaker passes), with a hand-written
Adam, for the benchmark's check of the port's training step.

One step: the speaker latent for the batch's speakers and for shuffled
ones; the trunk once; the head for each (the shuffled pass without a
graph); the generator loss (Huber, the clamped diversity term, KLD) and the
G term against the discriminator held frozen; the D term on the detached
sample with noisy targets (real, then fake); one backward over the sum;
Adam on the generator's trainable tensors and on the discriminator.

`draw_noise` draws a step's small random inputs from a CPU generator in a
fixed order; the same generator handed to the port's step gives it the same
draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import model as ref


@dataclass
class Noise:
    eps: torch.Tensor
    eps_rand: torch.Tensor
    perm: torch.Tensor
    target_noise: torch.Tensor
    fake_noise: torch.Tensor
    reprog_seed: int
    dropout_seed: int


def draw_noise(generator: torch.Generator, conf: dict, batch_size: int) -> Noise:
    """The draws of one step, in the order the step makes them: two rows of
    speaker noise, a permutation, the discriminator's real and fake noise,
    the attention-dropout seed, the dropout generator's seed (then one more
    speaker row and a seed that this step does not read)."""
    g = generator
    z, T, P = conf["hop"]["z_size"], conf["data"]["n_poses"], conf["derived"]["pose_dim"]
    eps = torch.randn(batch_size, z, generator=g)
    eps_rand = torch.randn(batch_size, z, generator=g)
    perm = torch.randperm(batch_size, generator=g)
    target_noise = torch.randn(batch_size, T, P, generator=g)
    fake_noise = torch.randn(batch_size, T, P, generator=g)
    reprog_seed = int(torch.randint(0, 2 ** 31, (1,), generator=g))
    dropout_seed = int(torch.randint(0, 2 ** 31, (1,), generator=g))
    return Noise(eps, eps_rand, perm, target_noise, fake_noise, reprog_seed, dropout_seed)


def huber(pred, target, beta: float, reduce: bool = True):
    d = torch.abs(pred - target) / beta
    out = torch.where(d < 1.0, 0.5 * d * d, d - 0.5) * beta
    return out.mean() if reduce else out


class Adam:
    """torch's Adam update, written out: m, v, bias corrections, eps outside
    the square root."""

    def __init__(self, params: dict, lr: float, betas, eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, tuple(betas), eps
        self.state = {}

    def step(self):
        b1, b2 = self.betas
        with torch.no_grad():
            for name, p in self.params.items():
                if p.grad is None:
                    continue
                st = self.state.setdefault(name, {"t": 0, "m": torch.zeros_like(p),
                                                  "v": torch.zeros_like(p)})
                st["t"] += 1
                g = p.grad
                st["m"].mul_(b1).add_(g, alpha=1 - b1)
                st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1 = 1 - b1 ** st["t"]
                bc2 = 1 - b2 ** st["t"]
                denom = (st["v"].sqrt() / (bc2 ** 0.5)).add_(self.eps)
                p.addcdiv_(st["m"], denom, value=-self.lr / bc1)


class GANStep:
    """The generator's and the discriminator's tensors, their Adams, and the
    fused GAN step over them."""

    def __init__(self, conf: dict, gen: dict, disc: dict):
        self.conf = conf
        self.gen = {k: v.clone() for k, v in gen.items()}
        self.disc = {k: v.clone() for k, v in disc.items()}
        for name, t in self.gen.items():
            t.requires_grad_(ref.trainable(name))
        for name, t in self.disc.items():
            t.requires_grad_(not ref.is_buffer(name))
        tr = conf["train"]
        self.gen_opt = Adam({k: v for k, v in self.gen.items() if v.requires_grad},
                            tr["learning_rate"], tr["betas"])
        self.dis_opt = Adam({k: v for k, v in self.disc.items() if v.requires_grad},
                            tr["learning_rate"] * tr["dis_lr_scale"], tr["betas"])

    def __call__(self, batch: dict, noise: Noise) -> dict:
        """One step; returns its loss terms as floats and leaves each
        tensor's gradient in `.grad`."""
        conf, lc = self.conf, self.conf["loss"]
        device = batch["in_audio"].device
        for t in list(self.gen.values()) + list(self.disc.values()):
            t.grad = None
        dev = {k: getattr(noise, k).to(device) for k in
               ("eps", "eps_rand", "perm", "target_noise", "fake_noise")}
        draws = ref.Draws(torch.Generator(device=device).manual_seed(noise.dropout_seed))
        G, D = self.gen, self.disc
        vids = batch["vid_indices"]
        z, mu, logvar = ref.speaker(G, vids, dev["eps"])
        z_rand, _, _ = ref.speaker(G, vids[dev["perm"]], dev["eps_rand"])
        feats = ref.trunk(G, conf, batch, draws, train=True, reprog_seed=noise.reprog_seed)
        out = ref.head(G, conf, feats, z)
        with torch.no_grad():
            out_rand = ref.head(G, conf, feats.detach(), z_rand.detach())
        target = batch["target_vec"]
        h = huber(out, target, lc["huber_beta"])
        pose_l1 = huber(out, out_rand, lc["div_beta"], reduce=False).sum(dim=(1, 2))
        z_l1 = torch.mean(torch.abs(z.detach() - z_rand.detach()), dim=-1)
        div_reg = torch.clamp(-(pose_l1 / (z_l1 + 1e-5)), min=lc["div_clamp"]).mean()
        kld = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
        terms = {"loss": h * lc["regression_weight"], "DIV_REG": div_reg * lc["reg_weight"],
                 "KLD": kld * lc["kld_weight"]}
        frozen = {k: v.detach() for k, v in D.items()}
        score = ref.discriminator(frozen, conf, out, draws)
        terms["gen"] = -torch.mean(torch.log(score + 1e-8)) * lc["gan_weight"]
        real = ref.discriminator(D, conf, target + 0.1 * dev["target_noise"], draws)
        fake = ref.discriminator(D, conf, out.detach() + 0.1 * dev["fake_noise"], draws)
        terms["dis"] = -torch.mean(torch.log(real + 1e-8) + torch.log(1.0 - fake + 1e-8))
        sum(terms.values()).backward()
        self.gen_opt.step()
        self.dis_opt.step()
        return {k: float(v.detach()) for k, v in terms.items()}

    def grads(self) -> dict:
        """The gradient of every trainable tensor, 'gen.'- and 'dis.'-prefixed."""
        out = {f"gen.{k}": v.grad for k, v in self.gen_opt.params.items()}
        out.update({f"dis.{k}": v.grad for k, v in self.dis_opt.params.items()})
        return {k: v for k, v in out.items() if v is not None}

    def tensors(self) -> dict:
        """Every trainable tensor, 'gen.'- and 'dis.'-prefixed."""
        out = {f"gen.{k}": v for k, v in self.gen_opt.params.items()}
        out.update({f"dis.{k}": v for k, v in self.dis_opt.params.items()})
        return out
