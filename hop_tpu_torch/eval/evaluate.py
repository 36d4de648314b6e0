"""Validation pass: L1, joint MAE, FGD, BC and diversity (port of
hop_tpu/eval/evaluate.py; reference Evaluate.py:50-291 evaluate_testset).

The generator runs with RANDOM speaker ids (Evaluate.py:167-169); L1
against the targets, FGD features pushed per batch, joint MAE after FK,
and beat consistency only when epoch > bc_start_epoch (the reference's
`epoch > 35` gate). The metrics stay on the device; the scalars are read
once, at the end.

Differences from hop_tpu, on purpose: the speaker ids come from a
`torch.Generator` (hop_tpu: `jax.random.randint` on a split key), or from
the caller (`speaker_ids`, so a test can give both packages the same ids).

The mesh branch (hop_tpu's evaluate.py:78-91, with `mesh` given in place of
hop_tpu's ambient one): a batch whose size the batch group divides is
split by rows, each rank generates its rows, and the generated poses are
gathered in rank order (`collectives.gather_rows`) before L1, joint MAE,
BC and the feature net, so every rank computes the metrics of the whole
batch, the same on every rank. A ragged batch runs whole on every rank, as
in hop_tpu. The speaker ids are drawn for the global batch, and so is the
generator's noise (`models.common.RowDraws`: each draw is the one-process
pass's, from the same generator, cut to the rank's rows), so the metrics
do not depend on the number of ranks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from hop_tpu_torch.config import Config
from hop_tpu_torch.eval import beat as beat_mod
from hop_tpu_torch.eval import metrics as metrics_mod
from hop_tpu_torch.eval.fgd import EmbeddingSpaceEvaluator
from hop_tpu_torch.models.common import RowDraws
from hop_tpu_torch.parallel.collectives import gather_rows


@dataclass
class EvalResult:
    loss: float
    mae: float
    frechet_dist: float
    feat_dist: float
    bc: float
    diversity: float
    elapsed_sec: float
    eval_net_trained: bool = True

    def __str__(self):
        s = ("[VAL] loss: {:.5f}, joint mae: {:.5f}, FGD: {:.5f}, "
             "feat_D: {:.5f}, BC: {:.4f} / {:.1f}s, Diversity: {:.3f}"
             .format(self.loss, self.mae, self.frechet_dist,
                     self.feat_dist, self.bc, self.elapsed_sec,
                     self.diversity))
        if not self.eval_net_trained:
            s += "  [FGD/diversity from an UNTRAINED feature net]"
        return s


@torch.no_grad()
def evaluate_testset(batches: Iterable[dict],
                     generate_fn: Callable,
                     evaluator: Optional[EmbeddingSpaceEvaluator],
                     epoch: int,
                     cfg: Config,
                     n_speakers: int,
                     generator: Optional[torch.Generator] = None,
                     speaker_ids: Optional[Iterator[torch.Tensor]] = None,
                     mesh=None) -> EvalResult:
    """generate_fn(batch, vid_indices, generator) -> (B, T, pose_dim)
    dir-vecs, for batches of tensors on one device (`device_batch`).

    Each batch's speaker ids are the next of `speaker_ids` when given, else
    drawn in [0, n_speakers) from `generator` (on the batch's device). On a
    rank of `mesh` every rank passes the whole batch; where it is split,
    generate_fn gets the rank's rows and a `RowDraws` in place of the
    generator (see the module's docstring).
    """
    skel = cfg.data.skeleton
    start = time.time()
    if evaluator is not None:
        evaluator.reset()

    losses, maes = [], []
    bc_nums, bc_dens = [], []
    compute_bc = epoch > cfg.loss.bc_start_epoch
    n_shards = mesh.batch_size if mesh is not None else 1

    for batch in batches:
        target = batch["target_vec"]
        B = target.shape[0]
        if speaker_ids is not None:
            vids = next(speaker_ids).to(target.device)
        else:
            vids = torch.randint(0, n_speakers, (B,), generator=generator,
                                 device=target.device)
        if n_shards > 1 and B % n_shards == 0:
            rows = mesh.rows(B // n_shards)
            outputs = gather_rows(generate_fn({k: v[rows] for k, v in batch.items()},
                                              vids[rows],
                                              RowDraws(generator, n_shards, mesh.batch_rank)),
                                  mesh.batch_group)
        else:
            outputs = generate_fn(batch, vids, generator)

        losses.append(metrics_mod.l1_loss(outputs, target))
        maes.append(metrics_mod.joint_mae(outputs, target, skel,
                                          cfg.data.n_pre_poses))
        if evaluator is not None:
            evaluator.push_samples(outputs, target)
        if compute_bc:
            # device scalars: a per-batch float() would wait for the card
            # every batch; they are read once at the end
            s, w = beat_mod.beat_consistency(outputs, batch["in_audio"], skel,
                                             cfg.data.pose_resampling_fps)
            bc_nums.append(s)
            bc_dens.append(w)

    if evaluator is not None:
        fd, feat_dist = evaluator.get_scores()
        diversity = evaluator.get_diversity_scores()
    else:
        fd = feat_dist = diversity = float("nan")

    bc_num = float(torch.stack(bc_nums).double().sum()) if bc_nums else 0.0
    bc_den = float(torch.stack(bc_dens).double().sum()) if bc_dens else 0.0
    return EvalResult(
        loss=float(np.mean(torch.stack(losses).double().cpu().numpy())),
        mae=float(np.mean(torch.stack(maes).double().cpu().numpy())),
        frechet_dist=fd,
        feat_dist=feat_dist,
        bc=bc_num / bc_den if bc_den > 0 else 0.0,
        diversity=diversity,
        elapsed_sec=time.time() - start,
        eval_net_trained=(evaluator is None
                          or getattr(evaluator, "trained", True)))
