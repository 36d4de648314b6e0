"""Pointwise metrics: joint-coordinate MAE after forward kinematics (port
of hop_tpu/eval/metrics.py; reference Evaluate.py:262-274).

Both the generated and the target dir-vecs get the dataset mean back, go
through FK, and the mean absolute difference is taken over frames 4+ (the
non-seed frames), on the tensors' device.
"""

from __future__ import annotations

import torch

from hop_tpu_torch import geometry


def joint_mae(out_dir_vec: torch.Tensor, target_dir_vec: torch.Tensor,
              skeleton: geometry.Skeleton, n_pre_poses: int = 4
              ) -> torch.Tensor:
    mean = torch.from_numpy(skeleton.mean_dir_vec).to(out_dir_vec.device)
    out_pose = geometry.convert_dir_vec_to_pose(out_dir_vec + mean, skeleton)
    tgt_pose = geometry.convert_dir_vec_to_pose(target_dir_vec + mean, skeleton)
    diff = out_pose[:, n_pre_poses:] - tgt_pose[:, n_pre_poses:]
    return torch.mean(torch.abs(diff))


def l1_loss(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(out - target))
