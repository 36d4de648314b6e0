"""The port's video rendering (hop_tpu_torch.utils.render) against
matplotlib's 3D axes and hop_tpu.utils.render, and test_checkpoint
--render-video.

matplotlib and Pillow are used here only, as the reference to hold the
port's numpy drawing and its own GIF encoder against: the projection of
the joints against `proj3d.proj_transform` under `view_init(20, -60)` with
render.py's limits (1e-6 on coordinates of O(0.1)), their pixels against
the axes' `transData` at dpi 80 (1e-6 px), the GIF decoded by Pillow (frame
count, 640 x 320, every pixel), the ffmpeg branch's command lines against
hop_tpu's (ffmpeg itself patched out), and the .wav byte for byte.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import animation  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402
from PIL import Image  # noqa: E402

from hop_tpu import geometry as jgeometry  # noqa: E402
from hop_tpu.utils import render as jrender  # noqa: E402

from hop_tpu_torch import geometry  # noqa: E402
from hop_tpu_torch.cli import test_checkpoint  # noqa: E402
from hop_tpu_torch.utils import render  # noqa: E402
from test_torch_train_step import one_torch_thread  # noqa: F401,E402 (a fixture)

PROJ_TOL = 1e-6
PIXEL_TOL = 1e-6


def _poses(skeleton, n, seed):
    r = np.random.default_rng(seed)
    dv = r.normal(0, 0.1, (n, skeleton.pose_dim)) + skeleton.mean_dir_vec.reshape(1, -1)
    return geometry.convert_dir_vec_to_pose(dv.astype(np.float32), skeleton).numpy()


def _mpl_axes():
    fig = plt.figure(figsize=(8, 4), dpi=render.DPI)
    axes = [fig.add_subplot(1, 2, k + 1, projection="3d") for k in range(2)]
    for ax in axes:
        ax.view_init(elev=20, azim=-60)
        ax.set_xlim3d(-0.5, 0.5)
        ax.set_ylim3d(0.5, -0.5)
        ax.set_zlim3d(0.5, -0.5)
    fig.canvas.draw()
    return fig, axes


@pytest.mark.parametrize("skeleton", [geometry.TED_SKELETON, geometry.EXPRESSIVE_SKELETON],
                         ids=["ted", "expressive"])
def test_projection_and_pixels_match_matplotlib(skeleton):
    fig, axes = _mpl_axes()
    pose = _poses(skeleton, 3, seed=1).reshape(-1, 3)
    xs, ys, zs = pose[:, 0], pose[:, 2], pose[:, 1]        # render.py's y/z swap
    for panel, ax in enumerate(axes):
        M = ax.get_proj()
        np.testing.assert_allclose(render.projection_matrix(), M, rtol=0, atol=1e-12)
        px, py, _ = proj3d.proj_transform(xs, ys, zs, M)
        got = render.project(np.stack([xs, ys, zs], axis=-1))
        np.testing.assert_allclose(got, np.stack([px, py], axis=-1), rtol=0, atol=PROJ_TOL)
        disp = ax.transData.transform(np.stack([px, py], axis=-1))
        want = np.stack([disp[:, 0], render.HEIGHT - disp[:, 1]], axis=-1)
        np.testing.assert_allclose(render.pose_pixels(pose, panel), want, rtol=0,
                                   atol=PIXEL_TOL)
    plt.close(fig)


def test_gif_decodes_to_the_drawn_frames(tmp_path):
    skeleton = geometry.TED_SKELETON
    out, tgt = _poses(skeleton, 6, seed=2), _poses(skeleton, 4, seed=3)
    frames = render.draw_frames(skeleton, out, tgt)
    assert frames.shape == (6, render.HEIGHT, render.WIDTH)
    render.write_gif(str(tmp_path / "a.gif"), frames)
    im = Image.open(tmp_path / "a.gif")
    assert im.n_frames == 6 and im.size == (render.WIDTH, render.HEIGHT)
    for i in range(6):
        im.seek(i)
        rgb = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(rgb, render.PALETTE[frames[i]])
        # each bone's colour at the middle of its projected segment, in both
        # panels while the target lasts
        for panel, poses in ((1, out), (0, tgt)):
            if i >= len(poses):
                assert not frames[i][:, :render.WIDTH // 2].any()
                continue
            px = render.pose_pixels(poses[i], panel)
            for bone, (p, c, _) in enumerate(skeleton.pairs):
                col, row = ((px[p] + px[c]) / 2).astype(int)
                if frames[i][row, col] == 1 + bone % 10:
                    continue
                # a later bone may be drawn over this one's middle
                assert frames[i][row, col] in {1 + b % 10 for b in range(bone, len(skeleton.pairs))}


def test_lzw_survives_table_resets(tmp_path):
    """Noise fills GIF's 4096-code table many times: the clear codes and the
    width changes decode back to the same indices."""
    frames = np.random.default_rng(4).integers(0, 11, size=(2, 200, 300)).astype(np.uint8)
    render.write_gif(str(tmp_path / "n.gif"), frames)
    im = Image.open(tmp_path / "n.gif")
    for i in range(2):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      render.PALETTE[frames[i]])


def _audio():
    return np.random.default_rng(5).normal(0, 0.4, 16000 * 2).astype(np.float32)


def test_wav_is_hop_tpus(tmp_path):
    audio = _audio()
    render._write_wav(str(tmp_path / "a.wav"), audio, 16000)
    jrender._write_wav(str(tmp_path / "b.wav"), audio, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


class _FakeFfmpeg:
    """Popen of the frame pipe: records the command and the bytes piped."""

    calls = []

    def __init__(self, cmd, stdin=None):
        self.cmd, self.nbytes, self.returncode = cmd, 0, 0
        self.stdin = self
        _FakeFfmpeg.calls.append(self)
        open(cmd[-1], "wb").close()

    def write(self, data):
        self.nbytes += len(data)

    def close(self):
        pass

    def wait(self):
        return 0


@pytest.mark.parametrize("shortest", [False, True])
def test_ffmpeg_branch_runs_hop_tpus_commands(tmp_path, monkeypatch, shortest):
    runs = []

    def run(cmd, check=False, capture_output=False):
        runs.append(list(cmd))
        open(cmd[-1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0)

    def save(self, filename, *args, **kwargs):        # matplotlib's own ffmpeg writer
        open(filename, "wb").close()

    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/" + name)
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(subprocess, "Popen", _FakeFfmpeg)
    monkeypatch.setattr(animation.Animation, "save", save)
    _FakeFfmpeg.calls.clear()
    r = np.random.default_rng(6)
    dv = r.normal(0, 0.1, (5, 27)).astype(np.float32)
    paths = {}
    for name, mod, skel in (("port", render, geometry.TED_SKELETON),
                            ("jax", jrender, jgeometry.TED_SKELETON)):
        d = tmp_path / "out"
        paths[name] = mod.create_video_and_save(
            str(d), 3, "demo", None, dv, skel.mean_dir_vec, "t", skeleton=skel,
            audio=_audio(), clipping_to_shortest_stream=shortest)
        shutil.move(str(d), str(tmp_path / name))
    assert paths["port"] == paths["jax"] == str(tmp_path / "out" / "demo_3.mp4")
    assert len(runs) == 2 and runs[0] == runs[1]
    assert ("-shortest" in runs[0]) == shortest
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    (pipe,) = _FakeFfmpeg.calls
    assert pipe.cmd[0] == "ffmpeg" and "640x320" in pipe.cmd and "rgb24" in pipe.cmd
    assert pipe.cmd[pipe.cmd.index("-framerate") + 1] == "15"
    assert pipe.nbytes == 5 * render.WIDTH * render.HEIGHT * 3


def test_test_checkpoint_renders_a_video(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "3",
                                "--render-video", "--out", str(tmp_path / "demo")])
    log = capsys.readouterr().out
    assert out.shape == (64, 27)
    assert sorted(os.listdir(tmp_path / "demo")) == ["demo_0.gif", "demo_0.wav"]
    im = Image.open(tmp_path / "demo" / "demo_0.gif")
    assert im.n_frames == 64 and im.size == (640, 320)
    assert "rendered video in" in log
