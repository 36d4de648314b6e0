"""Human3.6M windows for the FGD feature net (port of hop_tpu/data/h36m.py;
reference data_loader/h36m_loader.py:14-107).

12 upper-body joints of the 32 are kept, centred on the hip, their axes
swapped and flipped, frontalised on the hip direction, the hips dropped,
then cut into 34-frame windows at stride 10 with frame stride 2; an item is
(poses, mean-centred dir-vecs), with Gaussian noise on the poses when
`augment` (its draws from `random.Random(seed)` and
`np.random.default_rng(seed)`, in hop_tpu's order). The dir-vec
conversions are the port's `geometry` in f32, as hop_tpu's run in f32.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from hop_tpu_torch import geometry

TRAIN_SUBJECTS = ["S1", "S5", "S6", "S7", "S8"]
TEST_SUBJECTS = ["S9", "S11"]
TARGET_JOINTS = [1, 6, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]


def rotation_matrix(axis, theta):
    axis = np.asarray(axis, float)
    axis = axis / math.sqrt(np.dot(axis, axis))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([[aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
                     [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
                     [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


def normalize_h36m(data: np.ndarray) -> np.ndarray:
    """(frames, 12, 3) raw -> hip-centred, axes fixed, frontalised, hips
    dropped: (frames, 10, 3)."""
    data = np.array(data, float)
    for f in range(data.shape[0]):
        data[f] -= data[f, 2]
        data[f] = data[f][:, (0, 2, 1)]
        data[f, :, 1] = -data[f, :, 1]
    for f in range(data.shape[0]):
        hip_vec = data[f, 1] - data[f, 0]
        angle = np.pi - math.atan2(hip_vec[2], hip_vec[0])
        if 180 < np.rad2deg(angle) < 360:
            angle -= np.deg2rad(360)
        data[f] = data[f] @ rotation_matrix([0, 1, 0], angle)
    return data[:, 2:]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


class Human36M:
    def __init__(self, positions_3d: dict, mean_dir_vec: np.ndarray,
                 is_train: bool = True, augment: bool = False,
                 n_poses: int = 34, frame_stride: int = 2,
                 window_stride: int = 10,
                 skeleton: geometry.Skeleton = geometry.TED_SKELETON,
                 seed: int = 0):
        """positions_3d: {subject: {action: (frames, 32, 3)}}, the payload of
        the reference's npz."""
        self.mean_dir_vec = np.asarray(mean_dir_vec, np.float32).reshape(-1)
        self.augment = augment
        self.skeleton = skeleton
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        subjects = TRAIN_SUBJECTS if is_train else TEST_SUBJECTS
        self.data = []
        for subject, actions in positions_3d.items():
            if subject not in subjects:
                continue
            for _, positions in actions.items():
                positions = normalize_h36m(positions[:, TARGET_JOINTS])
                for f in range(0, len(positions), window_stride):
                    end = f + n_poses * frame_stride
                    if end > len(positions):
                        break
                    self.data.append(positions[f:end:frame_stride])

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int):
        skel = self.skeleton
        dir_vec = geometry.convert_pose_seq_to_dir_vec(_f32(self.data[index]), skel)
        poses = geometry.convert_dir_vec_to_pose(dir_vec, skel).numpy()
        if self.augment:
            sigma2 = 0.002 if self._rng.random() < 0.2 else 0.0001
            poses = poses + self._np_rng.normal(0, sigma2 ** 0.5, poses.shape)
        dir_vec = geometry.convert_pose_seq_to_dir_vec(_f32(poses), skel).numpy()
        dir_vec = dir_vec.reshape(poses.shape[0], -1) - self.mean_dir_vec
        return poses.astype(np.float32), dir_vec.astype(np.float32)
