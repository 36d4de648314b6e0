"""The hierarchical (HA2G) cascade's train steps (port of
hop_tpu/train/hierarchy.py; reference train_eval/train_hierarchy.py:71-293,
3 stages on TED, and train_hierarchy_expressive.py:124-484, 6 stages on TED
Expressive).

The shared ResNetSE encodes the spectrogram into one speaker-blended
feature sequence per stage (`encode`); each stage generates its bone
subset, seeded by the previous stage's output on the shared bones
(`cascade`, the routing of `models.hierarchy.route_pre_seq`). The generator
loss: the Huber terms of every stage summed, the diversity regulariser of
a second cascade for shuffled speakers (no graph: its outputs and z enter
detached, and the stages hold no BatchNorm statistics it could update),
KLD of the last stage's latent, in the GAN step the G term, and the
softmax-contrastive text/audio alignment (`softmax_contrastive`: text
against the high-level audio features, minus text against the low-level
ones) and the physical angle prior (`physical_loss`, with the palm
pseudo-bones on TED Expressive), at the weights hop_tpu's train_main sets
for the hierarchy (`CONTRASTIVE_POS_WEIGHT`, `CONTRASTIVE_NEG_WEIGHT`,
`PHYSICAL_WEIGHT`).

Warmup step: the generator loss, Adam on the generator side (the audio
encoder, the text encoder and the stages, one optimizer: Adam's state is
per parameter, so hop_tpu's one Adam over the tree and the reference's
Adam per module are the same). GAN step (hop_tpu hierarchy.py:222-250):
first the D phase, a whole encode + cascade of its own (no graph; the audio
encoder's BatchNorm statistics chain through it), -mean(log D(real) +
log(1 - D(fake))) and Adam on the discriminator; then the warmup step's
update with the G term against the freshly updated discriminator
(`train.state.update_d_then_g`, `train.llm.gen_term`).

A step's small draws are a `StepNoise` of one speaker-noise row per stage
(`StepNoise.draw_stages`), drawn from the step's CPU generator or handed
in by a test; the dropout masks come from a device generator seeded from
it. A step is called as `step(state, batch, rng)` and returns (state,
metrics): "loss", "KLD", "DIV_REG", "c_pos", "c_neg", "phy", and in the GAN
step "gen" and "dis".

On a rank of a parallel run (`mesh`) the step takes the global batch's
semantics, as HOP's does (train/llm.py): the draws are the global batch's
and the rank keeps its rows (`StepNoise.for_rank`; the shuffled speakers
index the global batch's ids), the optimizers average the gradients over
the batch group, the metrics leave the step averaged over it, and the
ResNetSE's and the discriminator's BatchNorms take the global batch's
statistics (`parallel.attach_batch_group`). Huber, KLD, the diversity
regulariser, the G and D terms and the physical prior are means over rows,
so equal blocks of rows average to the global means. The contrastive terms
are not: their softmax runs over every pair of the global batch's rows, so
a rank gathers the second feature block of every rank (`gather_rows`) and
takes its own rows of the first against all of them (`softmax_contrastive`
with `group`).
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hop_tpu_torch.config import Config
from hop_tpu_torch.models import hierarchy as H
from hop_tpu_torch.models.common import device_constant, huber
from hop_tpu_torch.parallel.collectives import gather_rows, group_index, reduce_metrics
from hop_tpu_torch.train import hierarchy_expressive_stats as hx
from hop_tpu_torch.train.llm import StepNoise, gen_term, generator_terms, shuffled_vids
from hop_tpu_torch.train.state import GANTrainState, gan_train_state, update_d_then_g

#: the contrastive and physical terms' weights (hop_tpu/cli/train_main.py:210
#: sets them for the hierarchy)
CONTRASTIVE_POS_WEIGHT = 0.1
CONTRASTIVE_NEG_WEIGHT = 0.05
PHYSICAL_WEIGHT = 0.01
#: pairs of rows a chunk of `softmax_contrastive` holds at once: 2^23 pairs of
#: 32 features are 1 GiB of differences (8704 x 8704 at bs 256 in 10 chunks)
CONTRASTIVE_CHUNK_PAIRS = 1 << 23


def _contrastive_rows(f1: torch.Tensor, f2: torch.Tensor, first: int) -> torch.Tensor:
    """The cross-entropy summed over rows f1 of the inverse-distance logits
    against every row of f2, the labels first, first + 1, ...: each distance
    the exact norm of its difference."""
    d = torch.linalg.vector_norm(f1[:, None, :] - f2[None, :, :], dim=-1)
    logits = torch.clamp(1.0 / (d + 1e-8), min=1e-8)
    labels = torch.arange(first, first + f1.shape[0], device=f1.device)
    return F.cross_entropy(logits, labels, reduction="sum")


def softmax_contrastive(feat1: torch.Tensor, feat2: torch.Tensor,
                        chunk_pairs: int = CONTRASTIVE_CHUNK_PAIRS,
                        group=None) -> torch.Tensor:
    """Cross-entropy over inverse pairwise L2 distances of the normalised
    rows, the matching row the label (train_hierarchy.py:23-68; hop_tpu
    hierarchy.py:36-46). hop_tpu forms every difference at once (8704^2 x
    32 floats at bs 256, 9.7 GB, held again for the backward); here the rows
    go in chunks of `chunk_pairs` pairs, each recomputed in the backward
    (`torch.utils.checkpoint`), and the chunks' sums add in order. Each
    distance is the norm of its own difference, not ||a||^2 + ||b||^2 - 2ab,
    whose cancellation 1 / (d + 1e-8) would amplify for near rows.

    With `group` (a batch split over its ranks, each holding its block of
    rows of both features, in rank order) the pairs are the global batch's:
    the rank gathers every rank's rows of `feat2` (`gather_rows`, whose
    backward hands each rank the sum of every rank's gradient of its rows)
    and returns the mean over ITS rows of `feat1` against all of them, the
    labels offset by its first global row. The mean of the ranks' values,
    and of their gradients, is the one-process term's."""
    f1 = feat1 / torch.clamp(torch.linalg.vector_norm(feat1, dim=1, keepdim=True), min=1e-12)
    f2 = feat2 / torch.clamp(torch.linalg.vector_norm(feat2, dim=1, keepdim=True), min=1e-12)
    n = f1.shape[0]
    offset = 0
    if group is not None:
        offset = group_index(group) * n
        f2 = gather_rows(f2, group)
    rows = max(1, chunk_pairs // f2.shape[0])
    if rows >= n:
        return _contrastive_rows(f1, f2, offset) / n
    total = None
    for first in range(0, n, rows):
        part = checkpoint(_contrastive_rows, f1[first:first + rows], f2, offset + first,
                          use_reentrant=False, preserve_rng_state=False)
        total = part if total is None else total + part
    return total / n


def physical_loss(out_dir_vec: torch.Tensor, mean_dir_vec: np.ndarray, angle_pairs,
                  avg_angle, var_angle, add_palms: bool = False) -> torch.Tensor:
    """The angle prior sum_pairs mean((angle - avg)^2 / 2 var) over the
    frames (train_hierarchy.py:242-262); on TED Expressive the palms' cross
    products join as pseudo-bones (train_hierarchy_expressive.py:429-433)."""
    device = out_dir_vec.device
    vec = out_dir_vec + device_constant(np.asarray(mean_dir_vec, np.float32).tolist(),
                                        torch.float32, device)
    if add_palms:
        left = torch.linalg.cross(vec[:, :, 11 * 3:12 * 3], vec[:, :, 17 * 3:18 * 3], dim=-1)
        right = torch.linalg.cross(vec[:, :, 28 * 3:29 * 3], vec[:, :, 34 * 3:35 * 3],
                                   dim=-1)
        vec = torch.cat([vec, left, right], dim=-1)
    v = vec.reshape(vec.shape[0] * vec.shape[1], -1, 3)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    pairs = np.asarray(angle_pairs)
    first, second = (device_constant(pairs[:, i].tolist(), torch.long, device) for i in (0, 1))
    inner = torch.clamp(torch.sum(v[:, first] * v[:, second], dim=-1), -1 + 1e-7, 1 - 1e-7)
    angle = torch.arccos(inner) / math.pi
    avg = device_constant(avg_angle, torch.float32, device)
    var = device_constant(var_angle, torch.float32, device)
    return torch.sum(torch.mean((angle - avg) ** 2 / (2 * var), dim=0))


def make_hierarchy_train_steps(cfg: Config, net, disc, mesh=None):
    """Returns (warmup_step, gan_step, init_state) over `net` (a
    `models.hierarchy.HierarchyNet`) and `disc`
    (HierarchicalConvDiscriminator), both updated in place; on a rank of
    `mesh` where that is given."""
    loss_cfg, dataset = cfg.loss, cfg.data.dataset
    group = mesh.batch_group if mesh is not None and mesh.batch_size > 1 else None
    bones = H.stage_bones(dataset)
    skel = cfg.data.skeleton
    avg_angle, var_angle = ((H.TED_AVG_ANGLE, H.TED_VAR_ANGLE) if dataset == "TED"
                            else (hx.AVG_ANGLE, hx.VAR_ANGLE))

    def init_state() -> GANTrainState:
        return gan_train_state(cfg, net, disc, mesh)

    def encode(batch, vids, dev_gen):
        """(f_low, f_high, blends, text_feat): the audio encoder's taps and
        per-stage blends, and the text encoder's features."""
        _, f_low, _, f_high, blends = net.audio(batch["spectrogram"], vids)
        return f_low, f_high, blends, net.text(batch["text_padded"], dev_gen)

    def cascade(batch, blends, vids, eps, dev_gen):
        return net.cascade(batch["target_vec"], batch["text_padded"], blends, vids,
                           dev_gen, eps)

    def gen_loss(batch, noise: StepNoise, use_gan: bool, dev_gen):
        target, vids = batch["target_vec"], batch["vid_indices"]
        f_low, f_high, blends, text_feat = encode(batch, vids, dev_gen)
        outs, (z, mu, logvar) = cascade(batch, blends, vids, noise.eps, dev_gen)
        h = sum(huber(o, H.slice_target(target, bones[k]), loss_cfg.huber_beta)
                for k, o in enumerate(outs))
        # the diversity regulariser's cascade for shuffled speakers feeds only
        # detached terms (hop_tpu hierarchy.py:146-156)
        with torch.no_grad():
            outs_rand, (z_rand, _, _) = cascade(batch, blends, shuffled_vids(batch, noise),
                                                noise.eps_rand, dev_gen)
        loss, metrics, _ = generator_terms(outs[-1], outs_rand[-1], z, z_rand, mu, logvar,
                                           target, loss_cfg, regression=h)
        if use_gan:
            metrics["gen"] = gen_term(disc, outs[-1], dev_gen, loss_cfg.gan_weight)
            loss = loss + metrics["gen"]
        text = text_feat.reshape(-1, text_feat.shape[-1])
        metrics["c_pos"] = CONTRASTIVE_POS_WEIGHT * softmax_contrastive(
            text, f_high.reshape(-1, f_high.shape[-1]), group=group)
        metrics["c_neg"] = CONTRASTIVE_NEG_WEIGHT * -softmax_contrastive(
            text, f_low.reshape(-1, f_low.shape[-1]), group=group)
        metrics["phy"] = PHYSICAL_WEIGHT * physical_loss(
            outs[-1], skel.mean_dir_vec, skel.angle_pairs, avg_angle, var_angle,
            add_palms=dataset != "TED")
        loss = loss + metrics["c_pos"] + metrics["c_neg"] + metrics["phy"]
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
                    vids = batch["vid_indices"]
                    blends = net.audio(batch["spectrogram"], vids)[4]
                    fake = cascade(batch, blends, vids, noise.eps_dis, dev_gen)[0][-1]
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
                noise = StepNoise.draw_stages(rng, len(bones),
                                              B * (mesh.batch_size if mesh else 1),
                                              net.stages[0].speaker_mu.out_features)
            state, metrics = run_step(state, batch, noise.for_rank(mesh, B), use_gan)
            return state, reduce_metrics(metrics, group)
        return step

    return variant(False), variant(True), init_state
