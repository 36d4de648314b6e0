"""The port's geometry (hop_tpu_torch.geometry) against hop_tpu.geometry on
the same seeded numpy inputs, on the CPU.

The tables and the `Skeleton` properties are copies: equal exactly. FK is
one f32 product against the same path matrix on both sides, summed in
another order by the two libraries (a joint sums at most 8 bone terms of
O(1)): 1e-6 against hop_tpu and against an f64 per-bone loop. The
dir-vec conversion is the same f32 arithmetic (difference, norm,
division): bitwise.
Resampling, audio padding and the spectrogram length are the same numpy
code: equal exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hop_tpu import config as jcfg
from hop_tpu import geometry as J

from hop_tpu_torch import config as tcfg
from hop_tpu_torch import geometry as G

SKELETONS = [("ted", J.TED_SKELETON, G.TED_SKELETON),
             ("expressive", J.EXPRESSIVE_SKELETON, G.EXPRESSIVE_SKELETON)]
IDS = [s[0] for s in SKELETONS]
FK_TOL = 1e-6


def _naive_fk(vec, skeleton):
    """The FK definition bone by bone in f64."""
    if vec.shape[-1] != 3:
        vec = vec.reshape(vec.shape[:-1] + (-1, 3))
    vec = vec.astype(np.float64)
    out = np.zeros(vec.shape[:-2] + (skeleton.n_joints, 3))
    for b, (p, c, l) in enumerate(skeleton.pairs):
        out[..., c, :] = out[..., p, :] + l * vec[..., b, :]
    return out


@pytest.mark.parametrize("name,jskel,tskel", SKELETONS, ids=IDS)
def test_skeleton_tables_match(name, jskel, tskel):
    for attr in ("name", "pairs", "angle_pairs", "change_angle", "n_bones",
                 "n_joints", "pose_dim"):
        assert getattr(tskel, attr) == getattr(jskel, attr), attr
    for attr in ("fk_matrix", "parent_index", "child_index", "bone_lengths",
                 "mean_dir_vec", "mean_pose"):
        want, got = getattr(jskel, attr), getattr(tskel, attr)
        if want is None:
            assert got is None, attr
        else:
            np.testing.assert_array_equal(got, want, err_msg=attr)
            assert got.dtype == want.dtype, attr


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_config_skeleton_replaces_the_width_tables(dataset):
    port, ref = tcfg.DataConfig(dataset=dataset), jcfg.DataConfig(dataset=dataset)
    assert port.skeleton.name == ref.skeleton.name
    assert (port.pose_dim, port.n_joints_graph) == (ref.pose_dim, ref.n_joints_graph)


@pytest.mark.parametrize("name,jskel,tskel", SKELETONS, ids=IDS)
@pytest.mark.parametrize("shape", [(), (5,), (2, 34)])
@pytest.mark.parametrize("flat", [False, True])
def test_fk_matches_jax(name, jskel, tskel, shape, flat):
    r = np.random.default_rng(len(shape) + 10 * flat)
    vec = r.normal(size=shape + (jskel.n_bones, 3)).astype(np.float32)
    if flat:
        vec = vec.reshape(shape + (jskel.pose_dim,))
    want = np.asarray(J.convert_dir_vec_to_pose(vec, jskel))
    got = G.convert_dir_vec_to_pose(torch.from_numpy(vec), tskel)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FK_TOL)
    np.testing.assert_allclose(got.numpy(), _naive_fk(vec, tskel),
                               rtol=0, atol=FK_TOL)


@pytest.mark.parametrize("name,jskel,tskel", SKELETONS, ids=IDS)
def test_pose_to_dir_vec_matches_jax(name, jskel, tskel):
    r = np.random.default_rng(3)
    pose = (0.3 * r.normal(size=(4, 42, jskel.n_joints, 3))).astype(np.float32)
    pose[0, 0, 1] = pose[0, 0, 0]              # a zero-length bone stays zero
    want = np.asarray(J.convert_pose_seq_to_dir_vec(pose, jskel))
    got = G.convert_pose_seq_to_dir_vec(torch.from_numpy(pose), tskel)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy()[0, 0, 0] == 0)
    flat = G.convert_pose_seq_to_dir_vec(torch.from_numpy(pose.reshape(4, 42, -1)), tskel)
    np.testing.assert_array_equal(flat.numpy(), want)


def test_round_trip_through_fk():
    r = np.random.default_rng(4)
    vec = r.normal(size=(6, 9, 3))
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    pose = G.convert_dir_vec_to_pose(torch.tensor(vec, dtype=torch.float32))
    back = G.convert_pose_seq_to_dir_vec(pose)
    np.testing.assert_allclose(back.numpy(), vec, atol=1e-5)


@pytest.mark.parametrize("n,duration", [(50, 3.3), (500, 20.0), (37, 1.0)])
def test_resample_pose_seq_matches_jax(n, duration):
    poses = np.random.default_rng(n).normal(size=(n, 10, 3)).astype(np.float32)
    want = J.resample_pose_seq(poses, duration, 15)
    got = G.resample_pose_seq(poses, duration, 15)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("expected", [6, 10, 14, 36267])
def test_audio_length_and_spectrogram_length_match_jax(expected):
    a = np.random.default_rng(0).normal(size=10).astype(np.float32)
    np.testing.assert_array_equal(G.make_audio_fixed_length(a, expected),
                                  J.make_audio_fixed_length(a, expected))
    assert G.calc_spectrogram_length_from_motion_length(expected % 50 + 34, 15) == \
        J.calc_spectrogram_length_from_motion_length(expected % 50 + 34, 15)
