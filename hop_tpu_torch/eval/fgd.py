"""Embedding-space evaluator: FGD, feature distance and diversity, on the
device (port of hop_tpu/eval/fgd.py; reference
model/EmbeddingSpaceEvaluator.py:387-594).

The frozen feature net is EmbeddingNet(mode="pose") for pose_dim 27 (TED)
or MotionAE for pose_dim 126 (expressive). Features stay on the device
until the final scalars; the Fréchet distance uses the eigh-based square
root (ops/sqrtm.py). hop_tpu's `_gather_replicated` (an all-gather of each
feature block over a mesh) has its counterpart one step earlier: on a
parallel run `eval.evaluate` gathers the generated poses of a split batch,
and every rank pushes the whole batch here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hop_tpu_torch.ops.sqrtm import frechet_distance


def _fgd_stats(gen: torch.Tensor, real: torch.Tensor):
    """(Fréchet distance, feature distance) of two (N, F) feature sets
    (reference EmbeddingSpaceEvaluator.py:510-539 does this in host numpy
    and scipy)."""
    mu_g, mu_r = gen.mean(0), real.mean(0)

    # np.cov(rowvar=False) normalises by N-1
    def cov(x, mu):
        xc = x - mu
        return xc.T @ xc / (x.shape[0] - 1)

    fd = frechet_distance(mu_g, cov(gen, mu_g), mu_r, cov(real, mu_r))
    feat_dist = torch.mean(torch.sum(torch.abs(real - gen), dim=-1))
    return fd, feat_dist


class EmbeddingSpaceEvaluator:
    """Accumulates real and generated features; scores FGD and diversity."""

    def __init__(self, feature_fn, trained: bool = True):
        """feature_fn(poses) -> (recon, features): the frozen net's forward.

        trained=False marks a randomly initialised feature net (no
        --eval-net weights): FGD and diversity are then relative numbers
        within one run, never comparable to the reference's (which loads
        gesture_autoencoder_checkpoint_best.bin,
        EmbeddingSpaceEvaluator.py:393-414).
        """
        self._feature_fn = feature_fn
        self.trained = trained
        self.reset()

    def reset(self):
        self._real_feats = []
        self._gen_feats = []
        self._recon_err_diff = []

    @property
    def n_samples(self) -> int:
        return sum(f.shape[0] for f in self._real_feats)

    @torch.no_grad()
    def push_samples(self, generated_poses: torch.Tensor,
                     real_poses: torch.Tensor):
        real_recon, real_feat = self._feature_fn(real_poses)
        gen_recon, gen_feat = self._feature_fn(generated_poses)
        self._real_feats.append(real_feat)
        self._gen_feats.append(gen_feat)
        err_real = torch.mean(torch.abs(real_poses - real_recon))
        err_fake = torch.mean(torch.abs(generated_poses - gen_recon))
        self._recon_err_diff.append(err_fake - err_real)

    def get_scores(self):
        """(frechet_dist, feat_dist) — reference :510-539."""
        gen = torch.cat(self._gen_feats, dim=0)
        real = torch.cat(self._real_feats, dim=0)
        fd, feat_dist = _fgd_stats(gen, real)
        return float(fd), float(feat_dist)

    def get_diversity_scores(self, rng: Optional[np.random.Generator] = None,
                             n: int = 500):
        """Mean feature L1 between the first n generated BATCH blocks and a
        random permutation of the batch blocks (reference :498-508: vstack
        of generated_feat_list[:500] against vstack of a randperm over the
        batch list). The shuffle's unit is a whole batch, not a row, so a
        one-batch split scores 0."""
        feats = self._gen_feats
        feat1 = torch.cat(feats[:n], dim=0)
        rng = rng or np.random.default_rng(0)
        perm = rng.permutation(len(feats))[:n]
        feat2 = torch.cat([feats[x] for x in perm], dim=0)
        # the reference assumes equal-size batches (drop_last=True loaders);
        # a ragged tail is cut to the shorter stack instead of failing
        m = min(feat1.shape[0], feat2.shape[0])
        return float(torch.mean(torch.sum(torch.abs(feat1[:m] - feat2[:m]), dim=-1)))


def make_ted_feature_fn(net):
    """EmbeddingNet(mode="pose"), in eval mode: features = the pose
    encoder's latent (mu)."""
    def fn(poses):
        _, _, _, feat, _, _, recon = net(None, None, poses[:, :4], poses)
        return recon, feat
    return fn


def make_expressive_feature_fn(net):
    """MotionAE, in eval mode: features = the encoder's latent."""
    def fn(poses):
        recon, feat = net(poses)
        return recon, feat
    return fn
