"""Beat consistency (BC): audio onsets against gesture motion beats, on the
tensors' device (port of hop_tpu/eval/beat.py; reference
Evaluate.py:175-255).

Motion beats are strict local minima of the normalised inter-bone
angle-change signal whose drop from a neighbour reaches `thres`; audio
beats come from the onset detector (ops/onset.py). The score is the mean
over audio onsets of exp(-min_t (t_onset - t_beat)^2 / (2 sigma^2)),
averaged over samples weighted by their onset counts — the reference's
AverageMeter weighting. Masks over fixed shapes: no per-sample Python, and
the (score sum, weight sum) pair stays on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from hop_tpu_torch import geometry
from hop_tpu_torch.ops import onset as onset_ops

THRES = 0.03   # Evaluate.py:24
SIGMA = 0.1    # Evaluate.py:25


def angle_diff_signal(out_dir_vec: torch.Tensor,
                      skeleton: geometry.Skeleton) -> torch.Tensor:
    """(B, T, pose_dim) mean-centred dir-vecs -> (B, T) angle-change signal."""
    dev = out_dir_vec.device
    vec = out_dir_vec + torch.from_numpy(skeleton.mean_dir_vec).to(dev)
    B, T = vec.shape[:2]

    if skeleton.name == "expressive":
        # palm pseudo-bones: cross(left wrist-index1, left wrist-ring1) etc.
        # (Evaluate.py:218-220)
        left = torch.linalg.cross(vec[:, :, 11 * 3:12 * 3], vec[:, :, 17 * 3:18 * 3])
        right = torch.linalg.cross(vec[:, :, 28 * 3:29 * 3], vec[:, :, 34 * 3:35 * 3])
        vec = torch.cat([vec, left, right], dim=-1)

    v = vec.reshape(B, T, -1, 3)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)

    pairs = torch.from_numpy(np.asarray(skeleton.angle_pairs)).to(dev)
    change = torch.tensor(skeleton.change_angle, dtype=torch.float32, device=dev)
    v1 = v[:, :, pairs[:, 0]]
    v2 = v[:, :, pairs[:, 1]]
    inner = torch.clamp(torch.sum(v1 * v2, dim=-1), -1.0, 1.0)
    angle = torch.arccos(inner) / math.pi          # (B, T, P)
    d = torch.abs(angle[:, 1:] - angle[:, :-1])    # (B, T-1, P)
    d = torch.sum(d / change, dim=-1) / len(skeleton.change_angle)
    return torch.cat([torch.zeros((B, 1), device=dev), d], dim=1)  # (B, T)


def motion_beat_mask(angle_diff: torch.Tensor, thres: float = THRES
                     ) -> torch.Tensor:
    """Strict local minima with a >= thres drop, frames 2..T-2
    (Evaluate.py:198-203)."""
    prev = angle_diff[:, :-2]
    cur = angle_diff[:, 1:-1]
    nxt = angle_diff[:, 2:]
    is_min = (cur < prev) & (cur < nxt)
    big_drop = ((prev - cur) >= thres) | ((nxt - cur) >= thres)
    mask = torch.zeros(angle_diff.shape, dtype=torch.bool, device=angle_diff.device)
    mask[:, 1:-1] = is_min & big_drop
    # the reference loop runs t in [2, 32] only — zero out frame 1
    mask[:, 1] = False
    return mask


def beat_consistency(out_dir_vec: torch.Tensor, in_audio: torch.Tensor,
                     skeleton: geometry.Skeleton, fps: float = 15.0,
                     sigma: float = SIGMA) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weighted score sum, weight sum) over the batch, as device
    scalars.

    Aggregate BC = sum(score_b * n_onsets_b) / sum(n_onsets_b), skipping
    samples without motion beats — the reference's bc.update(sum/len, len)
    accumulation (Evaluate.py:214).
    """
    dev = out_dir_vec.device
    ad = angle_diff_signal(out_dir_vec, skeleton)
    beats = motion_beat_mask(ad)                           # (B, T)
    beat_times = torch.arange(ad.shape[1], device=dev) / fps   # (T,)

    onsets = onset_ops.onset_detect_mask(in_audio)         # (B, F)
    onset_times = onset_ops.onset_frame_times(onsets.shape[1], device=dev)

    # pairwise squared gaps (F, T), min over *detected* motion beats
    gap2 = (onset_times[:, None] - beat_times[None, :]) ** 2
    masked = torch.where(beats[:, None, :], gap2[None],
                         torch.full_like(gap2[None], float("inf")))
    min_gap2 = torch.amin(masked, dim=-1)                  # (B, F)
    scores = torch.exp(-min_gap2 / (2 * sigma * sigma))
    scores = torch.where(torch.isfinite(min_gap2), scores, torch.zeros_like(scores))

    n_onsets = torch.sum(onsets, dim=1)                    # (B,)
    has_beats = torch.any(beats, dim=1)
    per_sample = torch.sum(torch.where(onsets, scores, torch.zeros_like(scores)), dim=1)
    valid = has_beats & (n_onsets > 0)
    # per-sample mean * weight n_onsets = plain sum; weight = n_onsets
    score_sum = torch.sum(torch.where(valid, per_sample, torch.zeros_like(per_sample)))
    weight_sum = torch.sum(torch.where(valid, n_onsets, torch.zeros_like(n_onsets)))
    return score_sum, weight_sum
