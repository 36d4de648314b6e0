"""Skeleton geometry: bone tables and dir-vec <-> pose forward kinematics
(port of hop_tpu/geometry.py; reference data_loader/data_utils.py:14-15,
46-120 for TED, utils/data_utils_expressive.py:12-67,100-170 for
TED-Expressive).

The tables and the `Skeleton` are numpy, copied from hop_tpu (whose module
imports jax). Forward kinematics and the pose -> dir-vec conversion are
torch functions on the tensor's device, in its dtype (f32 as hop_tpu's,
never promoted): FK is one product against a precomputed path matrix.
Resampling and audio padding stay host numpy, as in hop_tpu.

Conventions (identical to the reference):
  * A pose is (..., J, 3) joint coordinates; J = n_bones + 1 (root included).
  * A dir-vec array is (..., B, 3) unit vectors along bones, ordered by the
    bone table. Flattened forms (..., B*3) are accepted everywhere.
  * Bone b = (parent, child, length): child = parent + length * unit_vec.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

# TED Gesture skeleton: 10 joints / 9 bones (reference data_utils.py:14-15).
TED_DIR_VEC_PAIRS = (
    (0, 1, 0.26), (1, 2, 0.18), (2, 3, 0.14), (1, 4, 0.22), (4, 5, 0.36),
    (5, 6, 0.33), (1, 7, 0.22), (7, 8, 0.36), (8, 9, 0.33),
)

# TED Expressive skeleton: 43 joints / 42 bones incl. fingers & face
# (reference utils/data_utils_expressive.py:12-67).
EXPRESSIVE_DIR_VEC_PAIRS = (
    (0, 1, 0.26),
    (1, 2, 0.22), (1, 3, 0.22),
    (2, 4, 0.36), (4, 6, 0.33),
    (6, 8, 0.137), (8, 9, 0.044), (9, 10, 0.031),
    (6, 11, 0.144), (11, 12, 0.042), (12, 13, 0.033),
    (6, 14, 0.127), (14, 15, 0.027), (15, 16, 0.026),
    (6, 17, 0.134), (17, 18, 0.039), (18, 19, 0.033),
    (6, 20, 0.068), (20, 21, 0.042), (21, 22, 0.036),
    (3, 5, 0.36), (5, 7, 0.33),
    (7, 23, 0.137), (23, 24, 0.044), (24, 25, 0.031),
    (7, 26, 0.144), (26, 27, 0.042), (27, 28, 0.033),
    (7, 29, 0.127), (29, 30, 0.027), (30, 31, 0.026),
    (7, 32, 0.134), (32, 33, 0.039), (33, 34, 0.033),
    (7, 35, 0.068), (35, 36, 0.042), (36, 37, 0.036),
    (1, 38, 0.18), (38, 39, 0.14), (38, 40, 0.14),
    (39, 41, 0.15), (40, 42, 0.15),
)

# Beat-consistency angle pairs + per-pair mean |Δangle| normalisers
# (reference Evaluate.py:57-63 TED, :65-125 expressive).
TED_ANGLE_PAIRS = ((3, 4), (4, 5), (6, 7), (7, 8))
TED_CHANGE_ANGLE = (
    0.0034540758933871984, 0.007043459918349981,
    0.003493624273687601, 0.007205077446997166,
)

EXPRESSIVE_ANGLE_PAIRS = (
    (0, 1), (0, 2), (1, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10),
    (11, 12), (12, 13), (14, 15), (15, 16), (17, 18), (18, 19), (17, 5),
    (5, 8), (8, 14), (14, 11), (2, 20), (20, 21), (22, 23), (23, 24),
    (25, 26), (26, 27), (28, 29), (29, 30), (31, 32), (32, 33), (34, 35),
    (35, 36), (34, 22), (22, 25), (25, 31), (31, 28), (0, 37), (37, 38),
    (37, 39), (38, 40), (39, 41),
    # palm cross-product pseudo-bones appended at runtime (Evaluate.py:218-220)
    (4, 42), (21, 43),
)
EXPRESSIVE_CHANGE_ANGLE = (
    0.0027804733254015446, 0.002761547453701496, 0.005953566171228886,
    0.013764726929366589, 0.022748252376914024, 0.039307352155447006,
    0.03733552247285843, 0.03775784373283386, 0.0485558956861496,
    0.032914578914642334, 0.03800227493047714, 0.03757007420063019,
    0.027338404208421707, 0.01640886254608631, 0.003166505601257086,
    0.0017252820543944836, 0.0018696568440645933, 0.0016072227153927088,
    0.005681346170604229, 0.013287615962326527, 0.021516695618629456,
    0.033936675637960434, 0.03094293735921383, 0.03378918394446373,
    0.044323261827230453, 0.034706637263298035, 0.03369896858930588,
    0.03573163226246834, 0.02628341130912304, 0.014071882702410221,
    0.0029828345868736506, 0.0015706412959843874, 0.0017107439925894141,
    0.0014634154504165053, 0.004873405676335096, 0.002998138777911663,
    0.0030240598134696484, 0.0009890805231407285, 0.0012279648799449205,
    0.047324635088443756, 0.04472292214632034,
)

# Physical-prior angle statistics for the hierarchical trainer
# (reference train_eval/train_hierarchy.py:9-16).
TED_AVG_ANGLE = (0.22037504613399506, 0.4590071439743042,
                 0.22463147342205048, 0.45562979578971863)
TED_VAR_ANGLE = (0.0018439559498801827, 0.013570506125688553,
                 0.0017794054001569748, 0.013684595935046673)

# Dataset mean direction vectors (reference run_ted.py:115, Evaluate.py:128-143).
TED_MEAN_DIR_VEC = np.array([
    0.0154009, -0.9690125, -0.0884354, -0.0022264, -0.8655276, 0.4342174,
    -0.0035145, -0.8755367, -0.4121039, -0.9236511, 0.3061306, -0.0012415,
    -0.5155854, 0.8129665, 0.0871897, 0.2348464, 0.1846561, 0.8091402,
    0.9271948, 0.2960011, -0.013189, 0.5233978, 0.8092403, 0.0725451,
    -0.2037076, 0.1924306, 0.8196916], dtype=np.float32)

TED_MEAN_POSE = np.array([
    0.0000306, 0.0004946, 0.0008437, 0.0033759, -0.2051629, -0.0143453,
    0.0031566, -0.3054764, 0.0411491, 0.0029072, -0.4254303, -0.001311,
    -0.1458413, -0.1505532, -0.0138192, -0.2835603, 0.0670333, 0.0107002,
    -0.2280813, 0.112117, 0.2087789, 0.1523502, -0.1521499, -0.0161503,
    0.291909, 0.0644232, 0.0040145, 0.2452035, 0.1115339, 0.2051307],
    dtype=np.float32)

EXPRESSIVE_MEAN_DIR_VEC = np.array([
    -0.0737964, -0.9968923, -0.1082858, 0.9111595, 0.2399522, -0.102547,
    -0.8936886, 0.3131501, -0.1039348, 0.2093927, 0.958293, 0.0824881,
    -0.1689021, -0.0353824, -0.7588258, -0.2794763, -0.2495191, -0.614666,
    -0.3877234, 0.005006, -0.5301695, -0.5098616, 0.2257808, 0.0053111,
    -0.2393621, -0.1022204, -0.6583039, -0.4992898, 0.1228059, -0.3292085,
    -0.4753748, 0.2132857, 0.1742853, -0.2062069, 0.2305175, -0.5897119,
    -0.5452555, 0.1303197, -0.2181693, -0.5221036, 0.1211322, 0.1337591,
    -0.2164441, 0.0743345, -0.6464546, -0.5284583, 0.0457585, -0.319634,
    -0.5074904, 0.1537192, 0.1365934, -0.4354402, -0.3836682, -0.3850554,
    -0.4927187, -0.2417618, -0.3054556, -0.3556116, -0.281753, -0.5164358,
    -0.3064435, 0.9284261, -0.067134, 0.2764367, 0.006997, -0.7365526,
    0.2421269, -0.225798, -0.6387642, 0.3788997, 0.0283412, -0.5451686,
    0.5753376, 0.1935219, 0.0632555, 0.2122412, -0.0624179, -0.6755542,
    0.5212831, 0.1043523, -0.345288, 0.5443628, 0.128029, 0.2073687,
    0.2197118, 0.2821399, -0.580695, 0.573988, 0.0786667, -0.2133071,
    0.5532452, -0.0006157, 0.1598754, 0.2093099, 0.124119, -0.6504359,
    0.5465003, 0.0114155, -0.3203954, 0.5512083, 0.0489287, 0.1676814,
    0.4190787, -0.4018607, -0.3912126, 0.4841548, -0.2668508, -0.3557675,
    0.3416916, -0.2419564, -0.5509825, 0.0485515, -0.6343101, -0.6817347,
    -0.4705639, -0.6380668, 0.4641643, 0.4540192, -0.6486361, 0.4604001,
    -0.3256226, 0.1883097, 0.8057457, 0.3257385, 0.1292366, 0.815372],
    dtype=np.float32)


@dataclass(frozen=True)
class Skeleton:
    """A bone topology with everything FK / metrics need, precomputed."""

    name: str
    pairs: tuple  # ((parent, child, length), ...)
    angle_pairs: tuple = ()
    change_angle: tuple = ()
    mean_dir_vec: np.ndarray = field(default=None, repr=False)
    mean_pose: np.ndarray = field(default=None, repr=False)

    @property
    def n_bones(self) -> int:
        return len(self.pairs)

    @property
    def n_joints(self) -> int:
        return 1 + max(c for _, c, _ in self.pairs)

    @property
    def pose_dim(self) -> int:
        return self.n_bones * 3

    @functools.cached_property
    def fk_matrix(self) -> np.ndarray:
        """(n_bones, n_joints) reachability weights: pos = fk^T @ (len*vec).

        joint j's position is the sum of scaled bone vectors on the root->j
        path; building that path matrix once turns FK into a single matmul
        (vs the reference's per-bone Python loop, data_utils.py:77-98).
        """
        parents = {c: (p, i, l) for i, (p, c, l) in enumerate(self.pairs)}
        mat = np.zeros((self.n_bones, self.n_joints), dtype=np.float32)
        for j in range(self.n_joints):
            node = j
            while node in parents:
                p, bone_idx, length = parents[node]
                mat[bone_idx, j] += length
                node = p
        return mat

    @functools.cached_property
    def parent_index(self) -> np.ndarray:
        return np.array([p for p, _, _ in self.pairs], dtype=np.int32)

    @functools.cached_property
    def child_index(self) -> np.ndarray:
        return np.array([c for _, c, _ in self.pairs], dtype=np.int32)

    @functools.cached_property
    def bone_lengths(self) -> np.ndarray:
        return np.array([l for _, _, l in self.pairs], dtype=np.float32)


TED_SKELETON = Skeleton(
    name="ted",
    pairs=TED_DIR_VEC_PAIRS,
    angle_pairs=TED_ANGLE_PAIRS,
    change_angle=TED_CHANGE_ANGLE,
    mean_dir_vec=TED_MEAN_DIR_VEC,
    mean_pose=TED_MEAN_POSE,
)

EXPRESSIVE_SKELETON = Skeleton(
    name="expressive",
    pairs=EXPRESSIVE_DIR_VEC_PAIRS,
    angle_pairs=EXPRESSIVE_ANGLE_PAIRS,
    change_angle=EXPRESSIVE_CHANGE_ANGLE,
    mean_dir_vec=EXPRESSIVE_MEAN_DIR_VEC,
    mean_pose=None,
)


def _as_vec3(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[-1] != 3:
        x = x.reshape(*x.shape[:-1], n, 3)
    return x


def convert_dir_vec_to_pose(vec: torch.Tensor, skeleton: Skeleton = TED_SKELETON
                            ) -> torch.Tensor:
    """Direction vectors (..., B[, 3]) -> joint positions (..., J, 3), root
    pinned at the origin (reference data_utils.py:77-98), as one product
    against the path matrix."""
    vec = _as_vec3(torch.as_tensor(vec), skeleton.n_bones)
    fk = torch.from_numpy(skeleton.fk_matrix).to(vec.device, vec.dtype)
    return torch.einsum("...bc,bj->...jc", vec, fk)


def convert_pose_seq_to_dir_vec(pose: torch.Tensor,
                                skeleton: Skeleton = TED_SKELETON,
                                eps: float = 1e-12) -> torch.Tensor:
    """Joint positions (..., J[, 3]) -> unit bone vectors (..., B, 3)
    (reference data_utils.py:101-120, sklearn normalize semantics: zero-norm
    rows stay zero)."""
    pose = _as_vec3(torch.as_tensor(pose), skeleton.n_joints)
    child = torch.from_numpy(skeleton.child_index).to(pose.device, torch.long)
    parent = torch.from_numpy(skeleton.parent_index).to(pose.device, torch.long)
    diff = pose[..., child, :] - pose[..., parent, :]
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    return torch.where(norm > eps, diff / torch.clamp(norm, min=eps),
                       torch.zeros_like(diff))


def resample_pose_seq(poses: np.ndarray, duration_in_sec: float,
                      fps: float) -> np.ndarray:
    """Linear-resample (T, ...) pose frames to duration*fps frames.

    Host-side numpy (preprocessing path); matches reference
    data_utils.py:46-56 incl. its x_new = arange(0, n, n/expected) grid and
    linear extrapolation.
    """
    poses = np.asarray(poses)
    n = len(poses)
    expected_n = duration_in_sec * fps
    x_new = np.arange(0, n, n / expected_n)
    x0 = np.floor(x_new).astype(np.int64)
    x1 = x0 + 1
    w = (x_new - x0).astype(np.float64)
    flat = poses.reshape(n, -1).astype(np.float64)
    # linear extrapolation beyond the last sample, like scipy interp1d
    # with fill_value='extrapolate'
    lo = np.clip(x0, 0, n - 2)
    y0 = flat[lo]
    y1 = flat[lo + 1]
    out = y0 + (x_new - lo)[:, None] * (y1 - y0)
    out = out.reshape((len(x_new),) + poses.shape[1:])
    return out.astype(poses.dtype)


def make_audio_fixed_length(audio: np.ndarray, expected: int) -> np.ndarray:
    """Pad (symmetric) or crop 1-D audio to an exact length.

    Host-side; matches reference data_utils.py:68-74.
    """
    n_pad = expected - len(audio)
    if n_pad > 0:
        return np.pad(audio, (0, n_pad), mode="symmetric")
    return audio[:expected]


def calc_spectrogram_length_from_motion_length(n_frames: int, fps: float) -> int:
    """reference data_utils.py:41-43."""
    return int(round((n_frames / fps * 16000 - 1024) / 512 + 1))
