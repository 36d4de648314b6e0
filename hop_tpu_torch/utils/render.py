"""3D skeleton video rendering without matplotlib or Pillow (port of
hop_tpu/utils/render.py; reference convert.py:118-220).

The frames are drawn in numpy as hop_tpu's matplotlib figure shows them:
two panels of an 8 x 4 in figure at dpi 80 (640 x 320 px), the target on
the left and the generated poses on the right, each bone a segment about 5
px wide (5 pt) in matplotlib's default colour cycle, seen from elev 20,
azim -60 with y and z swapped into the plot axes and the mirrored limits
x (-0.5, 0.5), y and z (0.5, -0.5) (render.py:21-35), through the same
perspective as `Axes3D.get_proj()` and the same axes boxes and view limits
as matplotlib's 3D axes. What matplotlib draws besides the bones (titles,
axis panes, grid) is left out: there is no font here.

Writer: with `ffmpeg` on PATH, the raw RGB24 frames are piped to ffmpeg
for the `.mp4`, then the audio is muxed by render.py:95-108's command;
without it, a GIF written by this module's own GIF89a / LZW encoder
(each frame after the first as the rectangle that changed, as Pillow
writes it), with the `.wav` beside it: hop_tpu's Pillow branch, with the
same file names `{prefix}_{iter}.{ext}`.
"""

from __future__ import annotations

import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from hop_tpu_torch import geometry

#: the figure: 8 x 4 in at dpi 80
DPI = 80
WIDTH, HEIGHT = 8 * DPI, 4 * DPI
#: matplotlib's default cycle (tab10)
COLORS = np.array([[0x1f, 0x77, 0xb4], [0xff, 0x7f, 0x0e], [0x2c, 0xa0, 0x2c],
                   [0xd6, 0x27, 0x28], [0x94, 0x67, 0xbd], [0x8c, 0x56, 0x4b],
                   [0xe3, 0x77, 0xc2], [0x7f, 0x7f, 0x7f], [0xbc, 0xbd, 0x22],
                   [0x17, 0xbe, 0xcf]], np.uint8)
#: palette index 0 is the white background; bone i takes 1 + i % 10
PALETTE = np.concatenate([np.full((1, 3), 255, np.uint8), COLORS,
                          np.zeros((5, 3), np.uint8)])
#: 5 pt lines at dpi 80
LINE_PX = 5 * DPI / 72
#: the limits of render.py:21-35 (y and z mirrored)
LIMITS = ((-0.5, 0.5), (0.5, -0.5), (0.5, -0.5))
ELEV, AZIM = 20.0, -60.0
#: Axes3D's 2D view limits (`set_top_view`: -0.95 / 10 to 0.9 / 10)
VIEW_LIM = (-0.095, 0.09)


def _panel_boxes():
    """The two 3D axes' boxes in figure fractions (x0, y0, w, h):
    subplot(1, 2, k) under matplotlib's default subplot parameters (left
    0.125, right 0.9, bottom 0.11, top 0.88, wspace 0.2), shrunk to a square
    about its centre as `Axes3D.apply_aspect` does."""
    left, right, bottom, top, wspace = 0.125, 0.9, 0.11, 0.88, 0.2
    w = (right - left) / (2 + wspace)
    h = top - bottom
    side = min(w * WIDTH, h * HEIGHT)
    sw, sh = side / WIDTH, side / HEIGHT
    return [(left + k * (w + wspace * w) + (w - sw) / 2, bottom + (h - sh) / 2, sw, sh)
            for k in range(2)]


PANELS = _panel_boxes()


def projection_matrix(elev: float = ELEV, azim: float = AZIM,
                      limits=LIMITS) -> np.ndarray:
    """`Axes3D.get_proj()` for the default box aspect, camera distance 10,
    focal length 1, no roll and z vertical (matplotlib 3.9+)."""
    aspect = np.array([4.0, 4.0, 3.0])
    aspect *= 1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect)
    (x0, x1), (y0, y1), (z0, z1) = limits
    dx, dy, dz = (x1 - x0) / aspect[0], (y1 - y0) / aspect[1], (z1 - z0) / aspect[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
    centre = 0.5 * aspect
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye = centre + 10 * np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    w = (eye - centre) / np.linalg.norm(eye - centre)
    u = np.cross([0.0, 0.0, 1.0], w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -eye
    persp = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, -10], [0, 0, -1, 0]])
    return persp @ (rot @ shift) @ world


def project(points: np.ndarray, M: Optional[np.ndarray] = None) -> np.ndarray:
    """Plot-axes points (..., 3) -> their projected 2D coordinates (..., 2),
    as `proj3d.proj_transform` gives them."""
    M = projection_matrix() if M is None else M
    p = np.asarray(points, np.float64)
    h = p @ M[:, :3].T + M[:, 3]
    return h[..., :2] / h[..., 3:]


def to_pixels(xy: np.ndarray, panel: int) -> np.ndarray:
    """Projected 2D coordinates in a panel -> image (column, row) as floats,
    rows from the top (matplotlib's display coordinates, y flipped)."""
    x0, y0, w, h = PANELS[panel]
    span = VIEW_LIM[1] - VIEW_LIM[0]
    col = (x0 + (xy[..., 0] - VIEW_LIM[0]) / span * w) * WIDTH
    y = (y0 + (xy[..., 1] - VIEW_LIM[0]) / span * h) * HEIGHT
    return np.stack([col, HEIGHT - y], axis=-1)


def pose_pixels(poses: np.ndarray, panel: int) -> np.ndarray:
    """Joint positions (..., J, 3) -> their pixels (..., J, 2) in a panel:
    y and z swapped into the plot axes (render.py:25-28)."""
    return to_pixels(project(np.asarray(poses)[..., [0, 2, 1]]), panel)


def draw_segment(frame: np.ndarray, a, b, index: int, width: float = LINE_PX):
    """Set to `index` the pixels of `frame` (rows, cols) whose centres lie
    within width / 2 of the segment a-b ((column, row) pixel coordinates)."""
    r = width / 2
    lo = np.floor(np.minimum(a, b) - r).astype(int)
    hi = np.ceil(np.maximum(a, b) + r).astype(int)
    c0, r0 = max(lo[0], 0), max(lo[1], 0)
    c1, r1 = min(hi[0], frame.shape[1] - 1), min(hi[1], frame.shape[0] - 1)
    if c1 < c0 or r1 < r0:
        return
    cy, cx = np.mgrid[r0:r1 + 1, c0:c1 + 1] + 0.5
    d = np.asarray(b, np.float64) - a
    t = ((cx - a[0]) * d[0] + (cy - a[1]) * d[1]) / max(float(d @ d), 1e-12)
    t = np.clip(t, 0.0, 1.0)
    dist2 = (cx - a[0] - t * d[0]) ** 2 + (cy - a[1] - t * d[1]) ** 2
    frame[r0:r1 + 1, c0:c1 + 1][dist2 <= r * r] = index


def draw_frames(skeleton: geometry.Skeleton, out_poses: np.ndarray,
                tgt_poses: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, HEIGHT, WIDTH) uint8 palette indices: per frame the target's
    bones on the left (while it lasts) and the generated ones on the right,
    bone i in colour i % 10, drawn in bone order (render.py:21-35)."""
    n = len(out_poses)
    frames = np.zeros((n, HEIGHT, WIDTH), np.uint8)
    panels = [pose_pixels(out_poses, 1)]
    if tgt_poses is not None:
        panels.append(pose_pixels(tgt_poses, 0))
    for px in panels:
        for i in range(min(n, len(px))):
            for bone, (p, c, _) in enumerate(skeleton.pairs):
                draw_segment(frames[i], px[i, p], px[i, c], 1 + bone % 10)
    return frames


def _lzw(pixels: np.ndarray, min_size: int) -> bytes:
    """GIF's variable-width LZW of a flat array of palette indices: codes of
    min_size + 1 bits growing to 12, a clear code whenever the table fills,
    packed least significant bit first."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def width_of(next_code):   # the width the decoder reads the next code at
        return max(min_size + 1, (next_code - 1).bit_length())

    emit(clear, min_size + 1)
    table, next_code = {}, eoi + 1
    data = pixels.tolist()
    w = data[0]
    for k in data[1:]:
        key = (w << 8) | k
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, width_of(next_code))
        table[key] = next_code
        next_code += 1
        if next_code == 4096:
            emit(clear, 12)
            table, next_code = {}, eoi + 1
        w = k
    emit(w, width_of(next_code))
    emit(eoi, max(min_size + 1, next_code.bit_length()))
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: np.ndarray, fps: int = 15) -> None:
    """A looping GIF89a of (n, H, W) indices into PALETTE:
    the first frame whole, each later one as the rectangle that differs from
    the frame before (disposal 1, 'leave in place'), a delay of
    int(1000 / fps) // 10 hundredths of a second (Pillow's rounding)."""
    n, H, W = frames.shape
    size_bits = int(np.log2(len(PALETTE)))       # 16 colours
    min_size = max(2, size_bits)
    delay = int(1000 / fps) // 10
    le16 = lambda v: int(v).to_bytes(2, "little")   # noqa: E731
    with open(path, "wb") as f:
        f.write(b"GIF89a" + le16(W) + le16(H) + bytes([0xF0 | (size_bits - 1), 0, 0]))
        f.write(PALETTE.tobytes())
        f.write(b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00")      # loop forever
        prev = None
        for frame in frames:
            if prev is None:
                top, left, bottom, right = 0, 0, H, W
            else:
                rows, cols = np.nonzero(frame != prev)
                if rows.size:
                    top, bottom = rows.min(), rows.max() + 1
                    left, right = cols.min(), cols.max() + 1
                else:
                    top, left, bottom, right = 0, 0, 1, 1
            f.write(b"\x21\xF9\x04\x04" + le16(delay) + b"\x00\x00")
            f.write(b"\x2C" + le16(left) + le16(top) + le16(right - left)
                    + le16(bottom - top) + b"\x00")
            code = _lzw(frame[top:bottom, left:right].ravel(), min_size)
            f.write(bytes([min_size]))
            for i in range(0, len(code), 255):
                block = code[i:i + 255]
                f.write(bytes([len(block)]) + block)
            f.write(b"\x00")
            prev = frame
        f.write(b"\x3B")


def write_mp4(path: str, frames: np.ndarray, fps: int = 15) -> None:
    """The frames as RGB24 piped to ffmpeg (H.264, yuv420p), as matplotlib's
    FFMpegWriter invokes it."""
    n, H, W = frames.shape
    cmd = ["ffmpeg", "-f", "rawvideo", "-vcodec", "rawvideo", "-s", f"{W}x{H}",
           "-pix_fmt", "rgb24", "-framerate", str(fps), "-loglevel", "error",
           "-i", "pipe:", "-vcodec", "h264", "-pix_fmt", "yuv420p", "-y", path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    try:
        for frame in frames:
            proc.stdin.write(PALETTE[frame].tobytes())
    finally:
        proc.stdin.close()
        if proc.wait() != 0:
            raise RuntimeError(f"ffmpeg exited with {proc.returncode}: {' '.join(cmd)}")


def create_video_and_save(save_path: str, iter_idx, prefix: str,
                          target_dir_vec: Optional[np.ndarray],
                          output_dir_vec: np.ndarray,
                          mean_dir_vec: np.ndarray,
                          title: str,
                          skeleton: geometry.Skeleton = geometry.TED_SKELETON,
                          audio: Optional[np.ndarray] = None,
                          sample_rate: int = 16000,
                          clipping_to_shortest_stream: bool = False,
                          fps: int = 15) -> str:
    """hop_tpu's `create_video_and_save`: returns the path written,
    `{save_path}/{prefix}_{iter_idx}.mp4` (ffmpeg) or `.gif` (no ffmpeg, the
    audio as a `.wav` beside it). `title` is not drawn (no font)."""
    start = time.time()
    mean = np.asarray(mean_dir_vec).reshape(-1)
    out_poses = geometry.convert_dir_vec_to_pose(
        np.asarray(output_dir_vec) + mean, skeleton).numpy()
    tgt_poses = None
    if target_dir_vec is not None:
        tgt_poses = geometry.convert_dir_vec_to_pose(
            np.asarray(target_dir_vec) + mean, skeleton).numpy()
    frames = draw_frames(skeleton, out_poses, tgt_poses)

    Path(save_path).mkdir(parents=True, exist_ok=True)
    have_ffmpeg = shutil.which("ffmpeg") is not None
    ext = "mp4" if have_ffmpeg else "gif"
    video_path = str(Path(save_path) / f"temp_{prefix}_{iter_idx}.{ext}")
    (write_mp4 if have_ffmpeg else write_gif)(video_path, frames, fps=fps)

    final_path = str(Path(save_path) / f"{prefix}_{iter_idx}.{ext}")
    if audio is not None and not have_ffmpeg:
        _write_wav(str(Path(save_path) / f"{prefix}_{iter_idx}.wav"),
                   np.asarray(audio), sample_rate)
        Path(video_path).rename(final_path)
    elif audio is not None:
        audio_path = str(Path(save_path) / f"{prefix}_{iter_idx}.wav")
        _write_wav(audio_path, np.asarray(audio), sample_rate)
        cmd = ["ffmpeg", "-loglevel", "panic", "-y", "-i", video_path,
               "-i", audio_path, "-strict", "-2", final_path]
        if clipping_to_shortest_stream:
            cmd.insert(-1, "-shortest")
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            Path(video_path).unlink(missing_ok=True)
        except Exception:
            final_path = video_path
    else:
        Path(video_path).rename(final_path)

    print(f"rendered video in {time.time() - start:.1f}s: {final_path}")
    return final_path


def _write_wav(path: str, audio: np.ndarray, sr: int):
    """Minimal PCM16 WAV writer (no soundfile dependency)."""
    import wave
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
