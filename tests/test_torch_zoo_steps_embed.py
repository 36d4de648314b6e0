"""One train step of the embedding nets in the port against hop_tpu's
(hop_tpu.train.embed): joint_embedding and gesture_autoencoder on TED
(EmbeddingNet) and gesture_autoencoder on Expressive (MotionAE), from
identical converted state at tiny_test_config, B=4, inputs from a numpy
seed, under the tolerances and with the helpers of test_torch_zoo_steps.py;
where a test departs from them, its docstring says why."""

import jax
import numpy as np
import pytest

from hop_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from hop_tpu.models.motion_ae import MotionAE as JaxMotionAE
from hop_tpu.train.embed import make_embed_train_step as jax_embed_step
from hop_tpu.train.embed import make_motion_ae_train_step as jax_motion_ae_step

from hop_tpu_torch import convert
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.embedding_net import EmbeddingNet
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.train.embed import make_embed_train_step, make_motion_ae_train_step

from test_torch_zoo_steps import (N_WORDS, _batch, _cast, _check_metrics, _check_net,
                                  _no_port_dropout, _numpy, _one_net_run, _tb,
                                  no_dropout, one_torch_thread)  # noqa: F401 (fixtures)


@pytest.mark.parametrize("model", ["joint_embedding", "gesture_autoencoder"])
def test_embed_step_matches_jax(no_dropout, model):
    """EmbeddingNet's step on TED: joint_embedding runs the context encoder
    too (its statistics update; its latent feeds no loss, so its weights
    keep no gradient), gesture_autoencoder the pose autoencoder alone."""
    cfg_j, batch = _batch("TED")
    mode = "random" if model == "joint_embedding" else "pose"
    keys = (("text_padded", "in_audio", "target_vec") if mode != "pose"
            else ("target_vec",))
    net = JaxEmbeddingNet(pose_dim=27, n_frames=34, n_words=N_WORDS, mode=mode)
    text, audio = ((batch["text_padded"], batch["in_audio"]) if mode != "pose"
                   else (None, None))
    variables = _numpy(jax.jit(lambda k, *a: net.init(
        {"params": k, "dropout": k}, text, audio, *a, input_mode="pose", rng=k,
        train=True))(jax.random.PRNGKey(0), batch["target_vec"][:, :4],
                     batch["target_vec"]))
    want_m, want_g, want = _one_net_run(jax_embed_step(cfg_j, net, mode="pose"),
                                        variables, batch, keys)
    cfg = tiny_test_config("TED")
    port = EmbeddingNet(27, 34, N_WORDS, mode)
    port.load_state_dict(convert.embedding_net_state_dict_from_jax(variables), strict=True)
    _no_port_dropout(port)
    step, init_state = make_embed_train_step(cfg, port, mode="pose")
    _, metrics = step(init_state(), _tb(batch, keys), 0)
    _check_metrics(metrics, want_m)
    _check_net(port, convert.embedding_net_state_dict_from_jax, variables, want_g, want,
               cfg.train.learning_rate, model)
    if mode != "pose":
        assert all(p.grad is None for p in port.context_encoder.parameters())


def test_motion_ae_step_matches_jax(no_dropout):
    """gesture_autoencoder on Expressive (pose_dim 126) trains the MotionAE.
    JAX's step runs in f64 here: at B = 4 through two BatchNorms its own f32
    encoder gradients are 1.0-1.5e-4 of their largest off its f64 ones
    (the port's f32: 1.0-1.8e-5), over the gradient tolerance."""
    cfg_j, batch = _batch("TED_expressive")
    latent = cfg_j.baseline.motion_ae_latent_dim
    net = JaxMotionAE(pose_dim=126, latent_dim=latent)
    variables = _numpy(jax.jit(lambda k, t: net.init(k, t, True))(
        jax.random.PRNGKey(0), batch["target_vec"]))
    with jax.enable_x64(True):
        run = _one_net_run(jax_motion_ae_step(cfg_j, net), _cast(variables, np.float64),
                           {"target_vec": batch["target_vec"].astype(np.float64)},
                           ("target_vec",))
    want_m, want_g, want = _cast(run, np.float32)
    cfg = tiny_test_config("TED_expressive")
    port = MotionAE(126, latent)
    port.load_state_dict(convert.motion_ae_state_dict_from_jax(variables), strict=True)
    step, init_state = make_motion_ae_train_step(cfg, port)
    _, metrics = step(init_state(), _tb(batch, ("target_vec",)), None)
    _check_metrics(metrics, want_m)
    _check_net(port, convert.motion_ae_state_dict_from_jax, variables, want_g, want,
               cfg.train.learning_rate, "motion_ae")
