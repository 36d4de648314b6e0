"""The port's validation path (hop_tpu_torch.ops.sqrtm, .ops.onset,
.eval, .models.embedding_net, .models.motion_ae) against hop_tpu's on the
same seeded numpy inputs, on the CPU, and the whole validation pass —
records, dataset, `device_batch`, the HOP generator, the metrics — against
hop_tpu's with the same speaker ids and speaker noise.

Tolerances, each from f32 arithmetic done in another order by the two
libraries:
  * sqrtm of 32 x 32 and 128 x 128 covariances (entries O(1)): 1e-5
    against hop_tpu and against scipy's f64 sqrtm; the Fréchet distance
    1e-5 relative to both (measured <= 2e-6).
  * the onset envelope 1e-5 (values up to ~5); the onset mask, the motion
    beat mask and the peak picks are held EQUAL.
  * the angle-change signal, joint MAE and L1: 1e-5; BC's score and weight
    sums 1e-5 relative (the weight, an onset count, equal).
  * the feature nets through the converters, features and reconstructions:
    1e-5 (measured ~1e-6); feature distance and diversity from the same
    pushed poses 1e-5 relative. FGD 1e-3 relative: with fewer samples
    than the 32 feature dimensions the covariances are singular, and the
    square root of an eigenvalue at f32 round-off (~1e-7) is ~3e-4, on an
    FGD of ~0.7 (measured 3e-4 relative; hop_tpu's eigh sees the same).
  * the whole pass on the HOP generator: each side's log-mel (~1e-3 dB
    apart, tests/test_torch_device_batch.py) and ~20 layers of f32 put
    the outputs 1e-4 apart (tests/test_torch_hop_model.py); L1, MAE and
    feature distance 1e-3 relative, FGD 1e-2 relative (as above, on
    singular covariances of 10 samples), BC 1e-3 and diversity 1e-3
    relative. With a stand-in generator that both sides compute alike from
    the same batch, the pass agrees to 1e-5 relative (FGD 1e-3).
The JAX side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import dataclasses

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta

from hop_tpu import config as jcfg
from hop_tpu import geometry as JG
from hop_tpu.cli.common import device_batch as jax_device_batch
from hop_tpu.data import dataset as jds
from hop_tpu.data import preprocessor as jpre
from hop_tpu.data import synthetic as jsyn
from hop_tpu.data.vocab import build_vocab as jax_build_vocab
from hop_tpu.eval import beat as JB
from hop_tpu.eval import evaluate as JE
from hop_tpu.eval import fgd as JF
from hop_tpu.eval import metrics as JM
from hop_tpu.eval.torch_import import convert_embedding_net_pose, convert_motion_ae
from hop_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from hop_tpu.models.hop import HOPModel as JaxHOP
from hop_tpu.models.motion_ae import MotionAE as JaxMotionAE
from hop_tpu.ops import onset as JO
from hop_tpu.ops import sqrtm as JS

from hop_tpu_torch import config as tcfg
from hop_tpu_torch import geometry as TG
from hop_tpu_torch.cli.common import device_batch
from hop_tpu_torch.convert import (embedding_net_state_dict_from_jax,
                                   motion_ae_state_dict_from_jax, state_dict_from_jax)
from hop_tpu_torch.data import dataset as tds
from hop_tpu_torch.data import preprocessor as tpre
from hop_tpu_torch.data.synthetic import make_host_batch
from hop_tpu_torch.data.vocab import build_vocab
from hop_tpu_torch.eval import beat as TB
from hop_tpu_torch.eval import evaluate as TE
from hop_tpu_torch.eval import fgd as TF
from hop_tpu_torch.eval import metrics as TM
from hop_tpu_torch.models.embedding_net import EmbeddingNet
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.ops import onset as TO
from hop_tpu_torch.ops import sqrtm as TS

SQRTM_TOL = 1e-5
FRECHET_REL_TOL = 1e-5
ONSET_ENV_TOL = 1e-5
METRIC_TOL = 1e-5
NET_TOL = 1e-5
FGD_REL_TOL = 1e-3
DIV_REL_TOL = 1e-5
SKELETONS = [("ted", JG.TED_SKELETON, TG.TED_SKELETON),
             ("expressive", JG.EXPRESSIVE_SKELETON, TG.EXPRESSIVE_SKELETON)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


# -- sqrtm, Fréchet --------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(32, 0), (32, 1), (128, 2)])
def test_sqrtm_and_frechet_match_jax_and_scipy(n, seed):
    r = np.random.default_rng(seed)
    a = r.normal(size=(200, n)).astype(np.float32)
    b = (1.3 * r.normal(size=(150, n)) + 0.2).astype(np.float32)
    c1 = np.cov(a, rowvar=False).astype(np.float32)
    c2 = np.cov(b, rowvar=False).astype(np.float32)
    got = TS.sqrtm_psd(_t(c1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JS.sqrtm_psd(jnp.asarray(c1))),
                               rtol=0, atol=SQRTM_TOL)
    np.testing.assert_allclose(got.numpy(), scipy.linalg.sqrtm(c1.astype(np.float64)).real,
                               rtol=0, atol=SQRTM_TOL)
    mu1, mu2 = a.mean(0), b.mean(0)
    fd = float(TS.frechet_distance(_t(mu1), _t(c1), _t(mu2), _t(c2)))
    fd_jax = float(JS.frechet_distance(*(jnp.asarray(x) for x in (mu1, c1, mu2, c2))))
    c1d, c2d = c1.astype(np.float64), c2.astype(np.float64)
    fd_scipy = (np.sum((mu1 - mu2).astype(np.float64) ** 2) + np.trace(c1d)
                + np.trace(c2d) - 2 * np.trace(scipy.linalg.sqrtm(c1d @ c2d).real))
    assert _rel(fd, fd_jax) <= FRECHET_REL_TOL
    assert _rel(fd, fd_scipy) <= FRECHET_REL_TOL
    tr = float(TS.trace_sqrtm_product(_t(c1), _t(c2)))
    assert _rel(tr, float(JS.trace_sqrtm_product(jnp.asarray(c1), jnp.asarray(c2)))) \
        <= FRECHET_REL_TOL


# -- onsets, BC, MAE, L1 ---------------------------------------------------

def _audio(B, seed):
    return make_host_batch(tcfg.tiny_test_config(), B, seed=seed)["in_audio"]


def test_onset_mask_matches_jax():
    audio = _audio(8, 3)
    env = TO.onset_strength(_t(audio))
    np.testing.assert_allclose(env.numpy(), np.asarray(JO.onset_strength(jnp.asarray(audio))),
                               rtol=0, atol=ONSET_ENV_TOL)
    got = TO.onset_detect_mask(_t(audio))
    want = np.asarray(JO.onset_detect_mask(jnp.asarray(audio)))
    assert got.shape == want.shape == (8, 71) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 8
    np.testing.assert_array_equal(TO.onset_frame_times(71).numpy(),
                                  np.asarray(JO.onset_frame_times(71)))


@pytest.mark.parametrize("sr,hop", [(16000, 512), (44100, 512), (22050, 256), (16000, 256)])
def test_peak_pick_matches_jax_at_other_rates(sr, hop):
    """Rates where the max filter and the wait suppression (a loop over
    frames) are not the identity (wait = 1-2 frames)."""
    env = np.random.default_rng(sr + hop).random((3, 80)).astype(np.float32)
    got = TO.peak_pick_mask(_t(env), sr=sr, hop=hop).numpy()
    np.testing.assert_array_equal(got, np.asarray(JO.peak_pick_mask(jnp.asarray(env),
                                                                    sr=sr, hop=hop)))
    mask = env > 0.5
    for wait in (0, 1, 3):
        np.testing.assert_array_equal(
            TO._wait_suppress(_t(mask), wait).numpy(),
            np.asarray(JO._wait_suppress(jnp.asarray(mask), wait)))


def _outputs(skel, B, seed):
    r = np.random.default_rng(seed)
    walk = np.cumsum(0.2 * r.normal(size=(B, 34, skel.n_bones, 3)), axis=1)
    walk += r.normal(size=(B, 1, skel.n_bones, 3))
    walk /= np.linalg.norm(walk, axis=-1, keepdims=True)
    return (walk.reshape(B, 34, -1) - skel.mean_dir_vec).astype(np.float32)


@pytest.mark.parametrize("name,jskel,tskel", SKELETONS, ids=[s[0] for s in SKELETONS])
def test_beat_consistency_matches_jax(name, jskel, tskel):
    B = 6
    out, audio = _outputs(jskel, B, 1), _audio(B, 2)
    ad = TB.angle_diff_signal(_t(out), tskel)
    np.testing.assert_allclose(ad.numpy(), np.asarray(JB.angle_diff_signal(jnp.asarray(out), jskel)),
                               rtol=0, atol=METRIC_TOL)
    beats = TB.motion_beat_mask(ad)
    np.testing.assert_array_equal(beats.numpy(), np.asarray(JB.motion_beat_mask(
        JB.angle_diff_signal(jnp.asarray(out), jskel))))
    assert beats.any()
    s, w = TB.beat_consistency(_t(out), _t(audio), tskel)
    sj, wj = JB.beat_consistency(jnp.asarray(out), jnp.asarray(audio), jskel)
    assert int(w) == int(wj) > 0
    assert _rel(float(s), float(sj)) <= METRIC_TOL


@pytest.mark.parametrize("name,jskel,tskel", SKELETONS, ids=[s[0] for s in SKELETONS])
def test_joint_mae_and_l1_match_jax(name, jskel, tskel):
    out, tgt = _outputs(jskel, 5, 3), _outputs(jskel, 5, 4)
    assert _rel(float(TM.joint_mae(_t(out), _t(tgt), tskel)),
                float(JM.joint_mae(jnp.asarray(out), jnp.asarray(tgt), jskel))) <= METRIC_TOL
    assert _rel(float(TM.l1_loss(_t(out), _t(tgt))),
                float(JM.l1_loss(jnp.asarray(out), jnp.asarray(tgt)))) <= METRIC_TOL


# -- the feature nets and the evaluator -------------------------------------

def _perturb_stats(tree, r):
    """BatchNorm statistics away from (0, 1), so eval mode is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_stats(v, r)
        elif k == "mean":
            out[k] = r.normal(0, 0.5, v.shape).astype(np.float32)
        else:
            out[k] = r.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return out


def _jax_ted_net(seed=0):
    net = JaxEmbeddingNet(pose_dim=27, n_frames=34, n_words=10, mode="pose")
    poses = jnp.zeros((2, 34, 27))
    v = net.init(jax.random.PRNGKey(seed), None, None, poses[:, :4], poses,
                 input_mode="pose")
    v = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(v))
    v["batch_stats"] = _perturb_stats(v["batch_stats"], np.random.default_rng(seed))
    return net, v


def _jax_motion_ae(seed=1, latent=16):
    net = JaxMotionAE(pose_dim=126, latent_dim=latent)
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, 34, 126)))
    v = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(v))
    v["batch_stats"] = _perturb_stats(v["batch_stats"], np.random.default_rng(seed))
    return net, v


def _port_ted_net(variables):
    net = EmbeddingNet(27, 34, 10).eval()
    net.load_state_dict(embedding_net_state_dict_from_jax(variables), strict=True)
    return net


def _port_motion_ae(variables, latent=16):
    net = MotionAE(126, latent).eval()
    net.load_state_dict(motion_ae_state_dict_from_jax(variables), strict=True)
    return net


def _tree_equal(a, b):
    return jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, a, b))


def test_embedding_net_matches_flax_both_ways():
    jnet, v = _jax_ted_net()
    net = _port_ted_net(v)
    # the other direction: hop_tpu's importer reads the port's state_dict
    assert _tree_equal(convert_embedding_net_pose(
        {k: t.numpy() for k, t in net.state_dict().items()}), v)
    poses = np.random.default_rng(5).normal(size=(3, 34, 27)).astype(np.float32)
    want = jnet.apply(v, None, None, jnp.asarray(poses[:, :4]), jnp.asarray(poses),
                      input_mode="pose", train=False)
    with torch.no_grad():
        got = net(None, None, None, _t(poses))
    for i in (3, 4, 5, 6):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0,
                                   atol=NET_TOL, err_msg=str(i))
    assert got[0] is None and got[1] is None and got[2] is None


def test_motion_ae_matches_flax_both_ways():
    jnet, v = _jax_motion_ae()
    net = _port_motion_ae(v)
    assert _tree_equal(convert_motion_ae(
        {k: t.numpy() for k, t in net.state_dict().items()}), v)
    poses = np.random.default_rng(6).normal(size=(2, 34, 126)).astype(np.float32)
    jr, jz = jnet.apply(v, jnp.asarray(poses), False)
    with torch.no_grad():
        tr, tz = net(_t(poses))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=NET_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=NET_TOL)


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_embedding_space_evaluator_matches_jax(dataset):
    if dataset == "TED":
        jnet, v = _jax_ted_net()
        port = TF.EmbeddingSpaceEvaluator(TF.make_ted_feature_fn(_port_ted_net(v)))
        ref = JF.EmbeddingSpaceEvaluator(JF.make_ted_feature_fn(jnet, v))
        dim = 27
    else:
        jnet, v = _jax_motion_ae()
        port = TF.EmbeddingSpaceEvaluator(TF.make_expressive_feature_fn(_port_motion_ae(v)))
        ref = JF.EmbeddingSpaceEvaluator(JF.make_expressive_feature_fn(jnet, v))
        dim = 126
    for seed, B in ((0, 8), (1, 8), (2, 8), (3, 5)):     # a ragged last batch
        r = np.random.default_rng(seed)
        real = r.normal(size=(B, 34, dim)).astype(np.float32)
        gen = r.normal(loc=0.3, size=(B, 34, dim)).astype(np.float32)
        port.push_samples(_t(gen), _t(real))
        ref.push_samples(jnp.asarray(gen), jnp.asarray(real))
    assert port.n_samples == ref.n_samples == 29
    (fd, feat), (fd_j, feat_j) = port.get_scores(), ref.get_scores()
    assert _rel(fd, fd_j) <= FGD_REL_TOL and _rel(feat, feat_j) <= DIV_REL_TOL
    div, div_j = port.get_diversity_scores(), ref.get_diversity_scores()
    assert div > 0 and _rel(div, div_j) <= DIV_REL_TOL
    for seed in (3, 7):
        assert _rel(port.get_diversity_scores(np.random.default_rng(seed)),
                    ref.get_diversity_scores(np.random.default_rng(seed))) <= DIV_REL_TOL
    for a, b in zip(port._recon_err_diff, ref._recon_err_diff):
        assert abs(float(a) - float(b)) <= NET_TOL


def test_diversity_of_one_batch_is_zero():
    """The shuffle's unit is a whole batch: one batch is its own
    permutation (hence every eval test uses 2+ batches)."""
    _, v = _jax_ted_net()
    ev = TF.EmbeddingSpaceEvaluator(TF.make_ted_feature_fn(_port_ted_net(v)))
    poses = np.random.default_rng(0).normal(size=(8, 34, 27)).astype(np.float32)
    ev.push_samples(_t(poses + 0.1), _t(poses))
    assert ev.get_diversity_scores() == 0.0


# -- the validation pass ----------------------------------------------------

N_SPEAKERS = 7


def _f32(cfg):
    return cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False))


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """The same hop_tpu source clips through each package's preprocessor and
    dataset: (port cfg, port dataset), (jax cfg, jax dataset); 10 windows."""
    tmp = tmp_path_factory.mktemp("eval")
    tc, jc = _f32(tcfg.tiny_test_config()), _f32(jcfg.tiny_test_config())
    clips = jsyn.make_source_clips(jc, n_videos=2, clip_seconds=6.0, seed=4)
    assert tpre.DataPreprocessor(tc.data, str(tmp / "p")).run(clips) == \
        jpre.DataPreprocessor(jc.data, str(tmp / "j")).run(clips)
    port = tds.SpeechMotionDataset(str(tmp / "p"), tc.data)
    ref = jds.SpeechMotionDataset(str(tmp / "j"), jc.data)
    words = [[w for aux in port._aux_cache for w in aux["words"]]]
    port.set_lang_model(build_vocab("words", words, None, None, 300))
    ref.set_lang_model(jax_build_vocab("words", words, None, None, 300))
    return (tc, port), (jc, ref)


def _jax_draws(key, batches, n_speakers, z_size):
    """hop_tpu's evaluate_testset draws, batch by batch: the speaker ids and
    the speaker noise its generator's key gives."""
    ids, eps = [], []
    for B in batches:
        key, k_vid, k_gen = jax.random.split(key, 3)
        ids.append(torch.tensor(np.asarray(jax.random.randint(k_vid, (B,), 0, n_speakers))))
        eps.append(torch.tensor(np.asarray(jax.random.normal(k_gen, (B, z_size)))))
    return ids, eps


def _run_both(eval_data, jax_gen, port_gen, batch_size, epoch, evaluator_seed=0):
    (tc, port), (jc, ref) = eval_data
    jnet, v = _jax_ted_net(evaluator_seed)
    key = jax.random.PRNGKey(11)
    sizes = [len(b["vid_indices"]) for b in
             ref.batches(batch_size, shuffle=False, drop_last=False)]
    assert len(sizes) >= 3      # two batches keep their order: diversity 0
    ids, eps = _jax_draws(key, sizes, N_SPEAKERS, tc.hop.z_size)
    want = JE.evaluate_testset(
        (jax_device_batch(b, jc) for b in ref.batches(batch_size, shuffle=False,
                                                      drop_last=False)),
        jax_gen, JF.EmbeddingSpaceEvaluator(JF.make_ted_feature_fn(jnet, v)),
        epoch, jc, N_SPEAKERS, key)
    eps_it = iter(eps)
    got = TE.evaluate_testset(
        (device_batch(b, tc, device="cpu") for b in port.batches(
            batch_size, shuffle=False, drop_last=False)),
        lambda batch, vids, g: port_gen(batch, vids, next(eps_it)),
        TF.EmbeddingSpaceEvaluator(TF.make_ted_feature_fn(_port_ted_net(v))),
        epoch, tc, N_SPEAKERS, speaker_ids=iter(ids))
    return got, want


def _check_result(got, want, rel, fgd_rel):
    for f in ("loss", "mae", "feat_dist", "bc", "diversity"):
        assert _rel(getattr(got, f), getattr(want, f)) <= rel, (f, got, want)
    assert _rel(got.frechet_dist, want.frechet_dist) <= fgd_rel, (got, want)
    assert got.diversity > 0 and got.bc > 0
    assert got.eval_net_trained and want.eval_net_trained


def _standin(audio, log_mel, text, target, vids):
    """(B, 34, 27) from every input the generator reads (the log-mel
    scaled down: the frontends agree to ~1e-3 dB)."""
    t = np.arange(34)
    return np.tanh(0.5 * target + 0.002 * log_mel[:, :, :27]
                   + 0.01 * text[:, :, None] + 0.3 * audio[:, t * 1000][:, :, None]
                   + 0.1 * vids[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("epoch,batch_size", [(36, 4), (35, 3)])
def test_evaluate_testset_matches_jax_on_a_standin_generator(eval_data, epoch, batch_size):
    """The pass itself: batching, metrics, BC's epoch gate, the ids handed
    in, diversity over 3 batches with a ragged tail."""
    def jax_gen(batch, vids, key):
        return jnp.asarray(_standin(*(np.asarray(batch[k]) for k in (
            "in_audio", "log_mel", "text_padded", "target_vec")), np.asarray(vids)))

    def port_gen(batch, vids, eps):
        return _t(_standin(*(batch[k].numpy() for k in (
            "in_audio", "log_mel", "text_padded", "target_vec")), vids.numpy()))
    got, want = _run_both(eval_data, jax_gen, port_gen, batch_size, epoch)
    if epoch > 35:
        _check_result(got, want, METRIC_TOL, FGD_REL_TOL)
    else:
        assert got.bc == want.bc == 0.0       # BC only after epoch 35
        assert _rel(got.loss, want.loss) <= METRIC_TOL


@pytest.fixture
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("HOP_TPU_PALLAS_REPROG", "interpret")
    monkeypatch.setenv("HOP_TPU_PALLAS_GRU", "interpret-fused")


def test_validation_pass_matches_jax(eval_data, _interpret_kernels):
    """records -> dataset -> device_batch -> the tiny HOP generator (weights
    converted from the flax init) -> every metric, at 3 batches of 4."""
    (tc, _), (jc, _) = eval_data
    jmodel = JaxHOP(jc, n_speakers=N_SPEAKERS)
    B, d = 2, jc.data
    init_in = dict(in_audio=jnp.zeros((B, d.expected_audio_length)),
                   x_enc=jnp.zeros((B, d.n_poses, d.mel_bins)),
                   text=jnp.zeros((B, d.n_poses), jnp.int32),
                   pre_seq=jnp.zeros((B, d.n_seed_frames, d.pose_dim)),
                   vid_indices=jnp.zeros((B,), jnp.int32))
    variables = jax.jit(lambda key: jmodel.init({"params": key}, **init_in, rng=key))(
        jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, flax_meta.unbox(variables))
    model = HOPModel(tc, n_speakers=N_SPEAKERS)
    model.load_state_dict(state_dict_from_jax(variables, tc), strict=True)
    n_seed = d.n_seed_frames
    fwd = jax.jit(lambda v, a, m, t, p, vid, key: jmodel.apply(
        v, a, m, t, p, vid, rng=key, train=False)[0])

    def jax_gen(batch, vids, key):
        return fwd(variables, batch["in_audio"], batch["log_mel"], batch["text_padded"],
                   batch["target_vec"][:, :n_seed], vids, key)

    def port_gen(batch, vids, eps):
        with torch.inference_mode():
            return model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                         batch["target_vec"][:, :n_seed], vids, eps=eps)[0]
    got, want = _run_both(eval_data, jax_gen, port_gen, 4, 36)
    _check_result(got, want, 1e-3, 1e-2)
