"""Convert the reference's TED LMDB datasets into the record store (port of
hop_tpu/data/import_ted.py).

No package beyond numpy and torch: LMDB environments are parsed from disk
(`lmdbfile.LmdbReader`), values in the long-removed ``pyarrow.serialize``
format are decoded by `arrow_legacy.deserialize` (no pyarrow), pickled
values are detected too.

Two source kinds:

- ``--src-kind source`` (default): the reference's *source* LMDB, one
  value per video, ``{'vid', 'clips': [{skeletons_3d, audio_raw,
  audio_feat, words, start/end ...}]}`` (reference data_preprocessor.py:
  46-80). Each clip runs through the port's DataPreprocessor (windowing,
  motion filters, dir-vec normalisation) into ``<out>.bin/.idx``.
- ``--src-kind cache``: the reference's *preprocessed* ``*_cache`` LMDB,
  one value per window sample, ``[words, poses, normalized_dir_vec,
  audio, spectrogram, aux]`` (data_preprocessor.py:168-172). Samples are
  re-laid-out into the record store verbatim (no re-filtering), so an
  existing reference training cache imports bit for bit.

Usage (``--dry-import`` first: it checks one value against the preset in
seconds, where an import of the real TED data takes hours):

  python -m hop_tpu_torch.data.import_ted --src data/ted_dataset/lmdb_train \\
      --dry-import
  python -m hop_tpu_torch.data.import_ted --src data/ted_dataset/lmdb_train \\
      --out /data/records/train --dataset TED [--src-kind cache] [--verify]

``--verify`` checks the port's DSP and geometry against the librosa
outputs embedded in the artifact (every source clip's ``audio_feat`` is
librosa's extract_melspectrogram; every cache sample's ``vec_seq`` is the
normalized mean-centred dir-vec); librosa itself is not needed. The
log-mel runs on ``--device`` (default cuda), its matmuls in full f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pickle

import numpy as np
import torch

from hop_tpu_torch import geometry
from hop_tpu_torch.config import expressive_config, ted_config
from hop_tpu_torch.data import arrow_legacy
from hop_tpu_torch.data.lmdbfile import LmdbReader
from hop_tpu_torch.data.preprocessor import DataPreprocessor, SourceClip
from hop_tpu_torch.data.records import RecordWriter, schema_for
from hop_tpu_torch.ops import mel as mel_ops


def load_value(raw: bytes, fmt: str = "auto"):
    """Decode one LMDB value (legacy-pyarrow or pickle)."""
    if fmt == "pickle" or (fmt == "auto" and raw[:1] == b"\x80"):
        return pickle.loads(raw)
    return arrow_legacy.deserialize(raw)


def iter_source_videos(src_path: str, fmt: str = "auto"):
    """(vid, [SourceClip, ...]) per value of a source LMDB, in key order,
    each decoded only when reached."""
    with LmdbReader(src_path) as reader:
        for _, value in reader.items():
            video = load_value(value, fmt)
            clips = [SourceClip(
                vid=video["vid"],
                skeletons_3d=np.asarray(c["skeletons_3d"]),
                audio_raw=np.asarray(c["audio_raw"]),
                audio_spectrogram=np.asarray(c["audio_feat"]),
                words=c["words"],
                start_frame_no=c["start_frame_no"],
                end_frame_no=c["end_frame_no"],
                start_time=c["start_time"],
                end_time=c["end_time"],
            ) for c in video["clips"]]
            yield video["vid"], clips


class VerifyReport:
    """Running deviation stats for --verify (see `verify_clip_mel` /
    `verify_sample_dir_vec`). Real reference artifacts embed librosa
    outputs: every source clip carries an `audio_feat` spectrogram
    produced by librosa (data_preprocessor.py:111-133 slices it;
    data_utils.py:34-38 computes it) and every cache sample carries a
    librosa/sklearn-derived `vec_seq`, so the first import of real data
    doubles as an independent golden test of the mel filterbank / DFT /
    power_to_db constants (ops/mel.py) and the dir-vec geometry."""

    def __init__(self, mel_tol_db: float, vec_tol: float):
        self.mel_tol_db = mel_tol_db
        self.vec_tol = vec_tol
        self.mel_max_abs = 0.0
        self.mel_mean_abs = 0.0
        self.n_clips = 0
        self.vec_max_abs = 0.0
        self.n_samples = 0

    def check_mel(self, got: np.ndarray, want: np.ndarray, where: str):
        if got.shape != want.shape:
            raise ValueError(
                f"--verify {where}: recomputed spectrogram shape "
                f"{got.shape} != stored {want.shape} — n_fft/hop/mel-bin "
                "constants disagree with the artifact")
        dev = np.abs(got.astype(np.float64) - want.astype(np.float64))
        self.mel_max_abs = max(self.mel_max_abs, float(dev.max()))
        self.mel_mean_abs += float(dev.mean())
        self.n_clips += 1
        if dev.max() > self.mel_tol_db:
            raise ValueError(
                f"--verify {where}: recomputed log-mel deviates "
                f"{dev.max():.4f} dB from the artifact's librosa "
                f"spectrogram (tol {self.mel_tol_db}); worst bin at "
                f"{np.unravel_index(int(dev.argmax()), dev.shape)}")

    def check_vec(self, got: np.ndarray, want: np.ndarray, where: str):
        dev = np.abs(got.astype(np.float64) - want.astype(np.float64))
        self.vec_max_abs = max(self.vec_max_abs, float(dev.max()))
        self.n_samples += 1
        if dev.max() > self.vec_tol:
            raise ValueError(
                f"--verify {where}: recomputed dir-vec deviates "
                f"{dev.max():.2e} from the artifact's vec_seq "
                f"(tol {self.vec_tol:.0e})")

    def summary(self) -> str:
        parts = []
        if self.n_clips:
            parts.append(
                f"mel: {self.n_clips} clips, max|Δ| "
                f"{self.mel_max_abs:.3e} dB, mean|Δ| "
                f"{self.mel_mean_abs / self.n_clips:.3e} dB")
        if self.n_samples:
            parts.append(f"dir-vec: {self.n_samples} samples, max|Δ| "
                         f"{self.vec_max_abs:.3e}")
        return "verify ok — " + "; ".join(parts) if parts else \
            "verify: nothing checked"


def verify_clip_mel(clip, report: VerifyReport,
                    device: torch.device | str = "cuda"):
    """Recompute extract_melspectrogram (ops/mel.py) from the clip's raw
    audio on `device` and compare against the artifact's librosa-produced
    `audio_feat` (reference data_utils.py:34-38, stored as float16 by the
    reference; the default tolerance covers the f16 quantization of the
    [-80, 0] dB range). The matmuls run with TF32 off: the artifact came
    from librosa's f32 FFT, and the DFT's near-cancelling bins move by more
    than 2 dB under reduced-precision products. The setting found is
    restored."""
    matmul = torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        audio = torch.tensor(np.asarray(clip.audio_raw, np.float32), device=device)
        got = mel_ops.extract_melspectrogram(audio).cpu().numpy()
    finally:
        matmul.allow_tf32 = tf32
    report.check_mel(got, np.asarray(clip.audio_spectrogram),
                     f"clip of {clip.vid}")


def verify_sample_dir_vec(poses: np.ndarray, vec: np.ndarray, skel,
                          report: VerifyReport, where: str):
    """Recompute normalized mean-centred dir-vecs from the sample's
    pose_seq and compare against its stored vec_seq (reference
    data_preprocessor.py:160-166)."""
    got = geometry.convert_pose_seq_to_dir_vec(
        torch.tensor(np.asarray(poses, np.float32)), skel).numpy()
    if skel.mean_dir_vec is not None:
        got = got - skel.mean_dir_vec.reshape(-1, 3)
    report.check_vec(got, vec, where)


def verify_source_videos(videos, report: VerifyReport,
                         device: torch.device | str = "cuda"):
    for vid, clips in videos:
        for clip in clips:
            verify_clip_mel(clip, report, device)
        yield vid, clips


def import_cache(src_path: str, out_path: str, data_cfg, fmt: str = "auto",
                 strict: bool = True,
                 verify: VerifyReport | None = None) -> int:
    """Reference preprocessed-cache LMDB -> record store, sample-for-sample
    (value layout data_preprocessor.py:168-172, consumed by
    lmdb_data_loader.py:117-124)."""
    skel = data_cfg.skeleton
    schema = schema_for(data_cfg.n_poses, data_cfg.pose_resampling_fps,
                        skel.n_joints, skel.n_bones, data_cfg.mel_bins)
    n = 0
    with LmdbReader(src_path) as reader, RecordWriter(out_path, schema) as writer:
        for key, value in reader.items():
            words, poses, vec, audio, spec, aux = load_value(value, fmt)
            poses = np.asarray(poses, np.float32)
            vec = np.asarray(vec, np.float32).reshape(
                poses.shape[0], skel.n_bones, 3)
            if verify is not None:
                verify_sample_dir_vec(poses, vec, skel, verify,
                                      f"sample {key!r}")
            if poses.shape[0] != schema.n_frames_ext:
                msg = (f"sample {key!r}: {poses.shape[0]} frames, schema "
                       f"expects {schema.n_frames_ext} — wrong --dataset?")
                if strict:
                    raise ValueError(msg)
                logging.warning("%s (skipped)", msg)
                continue
            writer.append(
                poses, vec,
                np.asarray(audio, np.float32),
                np.asarray(spec, np.float32),
                aux={"vid": aux["vid"],
                     "words": [list(w) for w in words],
                     "start_frame_no": int(aux["start_frame_no"]),
                     "end_frame_no": int(aux["end_frame_no"]),
                     "start_time": float(aux["start_time"]),
                     "end_time": float(aux["end_time"])})
            n += 1
    return n


def dry_import(src_path: str, src_kind: str, data_cfg, fmt: str = "auto"):
    """Fast-fail validation of a user-supplied LMDB: parse the environment
    header, count entries, decode ONE value and check its schema, without
    running the full (hours-long on real TED data) import. Returns a
    summary dict; raises with a pointed message on mismatch."""
    with LmdbReader(src_path) as reader:
        n_entries = 0
        first = None
        for key, value in reader.items():
            if first is None:
                first = (key, value)
            n_entries += 1
    if first is None:
        raise ValueError(f"{src_path}: LMDB opens but contains no entries")
    key, value = first
    decoded = load_value(value, fmt)
    summary = {"path": src_path, "entries": n_entries,
               "first_key": key.decode("latin1"),
               "value_bytes": len(value)}
    if src_kind == "cache":
        if not (isinstance(decoded, (list, tuple)) and len(decoded) == 6):
            raise ValueError(
                f"{src_path}: first value is {type(decoded).__name__} of "
                f"length {len(decoded) if hasattr(decoded, '__len__') else '?'}"
                " — a reference cache LMDB holds 6-element samples "
                "[words, poses, vec, audio, spectrogram, aux] "
                "(data_preprocessor.py:168-172); is this a SOURCE lmdb? "
                "(drop --src-kind cache)")
        words, poses, vec, audio, spec, aux = decoded
        poses = np.asarray(poses)
        want = int(round(data_cfg.n_poses * 1.25))
        if poses.ndim < 2 or poses.shape[0] != want:
            raise ValueError(
                f"{src_path}: sample has {poses.shape} pose frames, schema "
                f"expects {want} extended frames — wrong --dataset preset?")
        summary.update(n_frames=int(poses.shape[0]),
                       pose_shape=tuple(poses.shape),
                       audio_len=int(np.asarray(audio).shape[0]),
                       vid=aux.get("vid"))
    else:
        if not (isinstance(decoded, dict) and "clips" in decoded):
            raise ValueError(
                f"{src_path}: first value is not a video dict with 'clips' "
                "(data_preprocessor.py:46-50) — is this a preprocessed "
                "CACHE lmdb? (add --src-kind cache)")
        clips = decoded["clips"]
        need = ("skeletons_3d", "audio_raw", "words", "start_time",
                "end_time")
        missing = [k for k in need if clips and k not in clips[0]]
        if missing:
            raise ValueError(f"{src_path}: clip record lacks keys {missing}")
        summary.update(vid=decoded.get("vid"), n_clips=len(clips),
                       skeleton_shape=tuple(np.asarray(
                           clips[0]["skeletons_3d"]).shape) if clips else ())
        if clips:
            n_joints = np.asarray(clips[0]["skeletons_3d"]).shape[1]
            if n_joints != data_cfg.skeleton.n_joints:
                raise ValueError(
                    f"{src_path}: clips carry {n_joints} joints, --dataset "
                    f"preset expects {data_cfg.skeleton.n_joints} "
                    "(TED=10, TED_expressive=43)")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--src", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--dry-import", action="store_true",
                   help="validate the LMDB's header/first sample against "
                        "the --dataset schema and exit — the first real "
                        "import run fails fast instead of hours in")
    p.add_argument("--dataset", default="TED",
                   choices=("TED", "TED_expressive"))
    p.add_argument("--src-kind", default="source",
                   choices=("source", "cache"))
    p.add_argument("--format", default="auto",
                   choices=("auto", "pickle", "pyarrow"))
    p.add_argument("--truncate-videos-frac", type=float, default=1.0,
                   help="0.5 reproduces the reference TED preprocessor's "
                        "first-half-of-videos quirk")
    p.add_argument("--disable-filtering", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="golden-check the port's DSP/geometry against the "
                        "librosa outputs embedded in the artifact: for "
                        "source LMDBs recompute each clip's log-mel "
                        "spectrogram from its raw audio (on --device) and "
                        "compare to the stored audio_feat; for cache LMDBs "
                        "recompute each sample's dir-vecs from pose_seq and "
                        "compare to vec_seq. Fails over tolerance")
    p.add_argument("--verify-tol-db", type=float, default=0.25,
                   help="max |Δ| in dB for the --verify mel check "
                        "(default covers the artifact's float16 "
                        "quantization + FFT-vs-matmul-DFT rounding)")
    p.add_argument("--verify-tol-vec", type=float, default=1e-4,
                   help="max |Δ| for the --verify dir-vec check")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --verify log-mel; 'cuda' is "
                        "the card, never a silent move to the CPU")
    args = p.parse_args(argv)

    cfg = ted_config() if args.dataset == "TED" else expressive_config()
    data_cfg = dataclasses.replace(
        cfg.data, truncate_videos_frac=args.truncate_videos_frac)

    if args.dry_import:
        summary = dry_import(args.src, args.src_kind, data_cfg, args.format)
        print("dry-import ok:", " ".join(f"{k}={v}"
                                         for k, v in summary.items()))
        return 0
    if args.out is None:
        p.error("--out is required (unless --dry-import)")
    report = (VerifyReport(args.verify_tol_db, args.verify_tol_vec)
              if args.verify else None)
    if args.src_kind == "cache":
        n = import_cache(args.src, args.out, data_cfg, args.format,
                         strict=not args.disable_filtering, verify=report)
    else:
        pre = DataPreprocessor(data_cfg, args.out,
                               disable_filtering=args.disable_filtering)
        with LmdbReader(args.src) as reader:
            n_videos = len(reader)
        videos = iter_source_videos(args.src, args.format)
        if report is not None:
            videos = verify_source_videos(videos, report, torch.device(args.device))
        n = pre.run(videos, n_videos)
    if report is not None:
        print(report.summary())
    logging.info("wrote %d samples to %s", n, args.out)
    print(f"imported {n} samples -> {args.out}.bin/.idx")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
