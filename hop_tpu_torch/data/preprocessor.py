"""Offline preprocessing: source clips -> filtered, windowed record store
(port of hop_tpu/data/preprocessor.py; host numpy, the pose -> dir-vec
conversion through the port's torch geometry on the CPU).

Counterpart of reference data_loader/data_preprocessor.py:16-224 and
data_loader/motion_preprocessor.py:4-87 (+ the expressive variants):
resample skeletons to 15 fps, slide extended windows
(n_poses_extended = round(n_poses * 1.25), stride 10), slice the raw audio /
cached spectrogram with symmetric end-padding, reject bad-motion windows,
convert poses to unit direction vectors and subtract the dataset mean, and
write the record store. `DataConfig.truncate_videos_frac` < 1 stops after
that share of the videos (the reference's 50%-of-videos quirk at 0.5; set
by data.import_ted).
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from hop_tpu_torch import geometry
from hop_tpu_torch.config import DataConfig
from hop_tpu_torch.data.records import RecordWriter, schema_for


class MotionFilter:
    """Window rejection rules (motion_preprocessor.py:4-87).

    TED checks wrists at joints (6, 9); expressive at (6, 7)
    (motion_preprocessor_expressive.py). Thresholds are the reference's.
    """

    def __init__(self, mean_pose: np.ndarray, skeleton: geometry.Skeleton):
        self.mean_pose = np.asarray(mean_pose, np.float64).reshape(-1, 3)
        self.wrist_joints = (6, 9) if skeleton.name == "ted" else (6, 7)

    def check_pose_diff(self, skeletons: np.ndarray) -> bool:
        return float(np.mean(np.abs(skeletons - self.mean_pose))) < 0.02

    def check_spine_angle(self, skeletons: np.ndarray) -> bool:
        spine = skeletons[:, 1] - skeletons[:, 0]
        spine = spine / np.linalg.norm(spine, axis=1, keepdims=True)
        angles = np.arccos(np.clip(spine @ np.array([0.0, -1.0, 0.0]),
                                   -1.0, 1.0))
        return (np.rad2deg(np.max(angles)) > 30
                or np.rad2deg(np.mean(angles)) > 20)

    def check_static_motion(self, skeletons: np.ndarray) -> bool:
        def var(j):
            return float(np.sum(np.var(skeletons[:, j], axis=0)))
        return all(var(j) < 0.0014 for j in self.wrist_joints)

    def __call__(self, skeletons: np.ndarray) -> str:
        """Returns 'PASS' or the rejection reason."""
        if self.check_pose_diff(skeletons):
            return "pose"
        if self.check_spine_angle(skeletons):
            return "spine angle"
        if self.check_static_motion(skeletons):
            return "motion"
        if np.isnan(skeletons).any():
            return "nan"
        return "PASS"


def get_words_in_time_range(word_list, start_time, end_time):
    """(word, start, end) tuples overlapping [start, end)
    (data_preprocessor.py:182-197)."""
    out = []
    for word in word_list:
        _, ws, we = word[0], word[1], word[2]
        if ws >= end_time:
            break
        if we <= start_time:
            continue
        out.append(list(word))
    return out


@dataclass
class SourceClip:
    """One contiguous speech segment of a video (the reference's source-LMDB
    clip dict, data_preprocessor.py:74-80)."""
    vid: str
    skeletons_3d: np.ndarray      # (frames, J, 3) at native fps
    audio_raw: np.ndarray         # 16 kHz waveform
    audio_spectrogram: np.ndarray  # (mels, frames) cache (extract_melspectrogram)
    words: list                   # [(word, start_sec, end_sec), ...]
    start_frame_no: int
    end_frame_no: int
    start_time: float
    end_time: float


class DataPreprocessor:
    def __init__(self, cfg: DataConfig, out_path: str,
                 disable_filtering: bool = False):
        self.cfg = cfg
        skel = cfg.skeleton
        self.n_poses_ext = int(round(cfg.n_poses * 1.25))
        self.schema = schema_for(cfg.n_poses, cfg.pose_resampling_fps,
                                 skel.n_joints, skel.n_bones, cfg.mel_bins)
        self.writer = RecordWriter(out_path, self.schema)
        self.filter = (None if disable_filtering else
                       MotionFilter(skel.mean_pose, skel)
                       if skel.mean_pose is not None else None)
        self.spectrogram_len = self.schema.spec_len
        self.audio_len = self.schema.audio_len
        self.n_out = 0
        self.n_filtered = defaultdict(int)

    def run(self, videos: Iterable[tuple], n_videos: Optional[int] = None) -> int:
        """videos: iterable of (vid, [SourceClip, ...]), consumed lazily.

        Respects cfg.truncate_videos_frac (the reference's 50%-of-videos
        quirk when set to 0.5) of `n_videos` videos; where that count is
        not given, `videos` is first listed to count them.
        """
        limit = math.inf
        if self.cfg.truncate_videos_frac < 1.0:
            if n_videos is None:
                videos = list(videos)
                n_videos = len(videos)
            limit = n_videos * self.cfg.truncate_videos_frac
        n_seen = 0
        for _vid, clips in videos:
            # the reference's loop (data_preprocessor.py:50-57): the video's
            # clips first, then the count and the check, so the video that
            # crosses the limit is still processed whole
            for clip in clips:
                self._sample_from_clip(clip)
            n_seen += 1
            if n_seen > limit:
                break
        self.writer.close()
        logging.info("preprocessor: %d samples, filtered %s",
                     self.n_out, dict(self.n_filtered))
        return self.n_out

    def _sample_from_clip(self, clip: SourceClip):
        cfg = self.cfg
        fps = cfg.pose_resampling_fps
        skel = cfg.skeleton
        skeletons = geometry.resample_pose_seq(
            clip.skeletons_3d, clip.end_time - clip.start_time, fps)

        n = len(skeletons)
        num_subdivision = math.floor(
            (n - self.n_poses_ext) / cfg.subdivision_stride) + 1
        spec = clip.audio_spectrogram
        audio = clip.audio_raw

        for i in range(max(num_subdivision, 0)):
            start = i * cfg.subdivision_stride
            fin = start + self.n_poses_ext
            sample_skel = skeletons[start:fin]
            t0 = clip.start_time + start / fps
            t1 = clip.start_time + fin / fps
            words = get_words_in_time_range(clip.words, t0, t1)
            if len(words) < 2:
                continue

            if self.filter is not None:
                verdict = self.filter(np.asarray(sample_skel, np.float64))
                if verdict != "PASS":
                    self.n_filtered[verdict] += 1
                    continue

            # spectrogram slice with symmetric end-padding
            a0 = math.floor(start / n * spec.shape[1])
            a1 = a0 + self.spectrogram_len
            if a1 > spec.shape[1]:
                pad = a1 - spec.shape[1]
                spec_s = np.pad(spec, ((0, 0), (0, pad)),
                                mode="symmetric")[:, a0:a1]
            else:
                spec_s = spec[:, a0:a1]

            # raw-audio slice
            a0 = math.floor(start / n * len(audio))
            a1 = a0 + self.audio_len
            if a1 > len(audio):
                audio_s = np.pad(audio, (0, a1 - len(audio)),
                                 mode="symmetric")[a0:a1]
            else:
                audio_s = audio[a0:a1]

            poses = np.asarray(sample_skel, np.float32)
            dir_vec = geometry.convert_pose_seq_to_dir_vec(
                torch.from_numpy(poses), skel).numpy()
            if skel.mean_dir_vec is not None:
                dir_vec = dir_vec - skel.mean_dir_vec.reshape(-1, 3)

            self.writer.append(
                poses, dir_vec, audio_s.astype(np.float32),
                spec_s.astype(np.float32),
                aux={"vid": clip.vid,
                     "words": words,
                     "start_frame_no": clip.start_frame_no + start,
                     "end_frame_no": clip.start_frame_no + fin,
                     "start_time": t0, "end_time": t1})
            self.n_out += 1


def calculate_data_mean(vec_seqs: Iterable[np.ndarray],
                        pose_seqs: Iterable[np.ndarray],
                        skeleton: geometry.Skeleton):
    """Dataset statistics (reference data_loader/calculate_motion_stats.py:
    10-58): mean dir-vec, mean pose, mean bone lengths."""
    vec_sum = np.zeros((skeleton.n_bones, 3), np.float64)
    pose_sum = np.zeros((skeleton.n_joints, 3), np.float64)
    bone_sum = np.zeros((skeleton.n_bones,), np.float64)
    n_v = n_p = 0
    for vec in vec_seqs:
        v = np.asarray(vec).reshape(-1, skeleton.n_bones, 3)
        vec_sum += v.sum(axis=0)
        n_v += v.shape[0]
    for pose in pose_seqs:
        p = np.asarray(pose).reshape(-1, skeleton.n_joints, 3)
        pose_sum += p.sum(axis=0)
        bones = (p[:, skeleton.child_index] - p[:, skeleton.parent_index])
        bone_sum += np.linalg.norm(bones, axis=-1).sum(axis=0)
        n_p += p.shape[0]
    return (vec_sum / max(n_v, 1), pose_sum / max(n_p, 1),
            bone_sum / max(n_p, 1))
