"""One speech2gesture train step in the port against hop_tpu's
(hop_tpu.train.speech2gesture), from identical converted state at
tiny_test_config, B=4, inputs from a numpy seed, under the tolerances and
with the helpers of test_torch_zoo_steps.py; where it departs from them,
the test's docstring says why."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hop_tpu.models import speech2gesture as js2g
from hop_tpu.train.speech2gesture import make_s2g_train_step as jax_s2g_step

from hop_tpu_torch import convert
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models import speech2gesture
from hop_tpu_torch.train.speech2gesture import make_s2g_train_step

from test_torch_zoo_steps import (STATS_TOL, STEP_KEY, _batch, _cast, _check_metrics,
                                  _check_net, _grads_of, _init, _jnp, _numpy, _tb,
                                  no_dropout, one_torch_thread)  # noqa: F401 (fixtures)


def test_s2g_step_matches_jax(no_dropout):
    """JAX's step runs in f64 here, and the port's twice, in f32 and in f64.
    The generator's f32 gradients are ill-conditioned: a convolution in front
    of a training-mode BatchNorm passes back gradients that sum to ~0 over
    the positions, so the BatchNorm before it (`decoder.1.1`) sums terms
    that cancel, and f32 round-off there (7e-2 of its bias gradient's largest
    element, against the port's own f64 step) reaches every layer before it
    (~1e-2); JAX's f32 is no better off. After one Adam step (each weight
    moves by lr times the sign of its gradient) the G term on the updated
    discriminator moves ~5e-5 relative between f32 runs. So: the f32 step's
    D phase ("loss", "dis", the discriminator's gradients and update, where
    JAX's own f32 gradients would be 0.6-1.1e-4 of their largest off its f64
    ones and the port's are 0.9-2.4e-5) against JAX's f64 step; the whole
    f64 step (every metric, both nets) at the usual tolerances."""
    cfg_j, batch = _batch("TED")
    keys = ("spectrogram", "target_vec")
    gen = js2g.Generator(n_poses=34, pose_dim=27, n_pre_poses=4)
    dis = js2g.Discriminator(pose_dim=27)
    init = {k: _cast(v, np.float64) for k, v in (
        ("gen", _init(gen, batch["spectrogram"], batch["target_vec"][:, :4])),
        ("dis", _init(dis, batch["target_vec"], seed=1)))}
    step, init_state = jax_s2g_step(cfg_j, gen, dis)
    with jax.enable_x64(True):
        state, want_m = step(init_state(_jnp(init["gen"]), _jnp(init["dis"])),
                             {k: jnp.asarray(batch[k], jnp.float64) for k in keys},
                             jax.random.PRNGKey(STEP_KEY))
        state = jax.tree_util.tree_map(np.asarray, state)
    want_m = {k: float(v) for k, v in want_m.items()}
    want = {"gen": {"params": _numpy(state.gen_params), "batch_stats": _numpy(state.gen_stats)},
            "dis": {"params": _numpy(state.dis_params), "batch_stats": _numpy(state.dis_stats)}}
    cfg = tiny_test_config("TED")
    lr = cfg.train.learning_rate
    lr_d = lr * cfg.train.dis_lr_scale
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        cast = (lambda t: t) if f64 else (lambda t: _cast(t, np.float32))
        port_gen = speech2gesture.Generator(34, 27, 4).to(dtype)
        port_gen.load_state_dict(convert.s2g_generator_state_dict_from_jax(init["gen"]))
        port_dis = speech2gesture.Discriminator(27).to(dtype)
        port_dis.load_state_dict(convert.s2g_discriminator_state_dict_from_jax(init["dis"]))
        pstep, pinit = make_s2g_train_step(cfg, port_gen, port_dis)
        _, metrics = pstep(pinit(), {k: v.to(dtype) for k, v in _tb(batch, keys).items()},
                           None)
        names = set(want_m) if f64 else {"loss", "dis"}
        _check_metrics({k: metrics[k] for k in names}, {k: want_m[k] for k in names})
        # f32: the G term's forward on the updated discriminator, whose conv
        # biases in front of BatchNorms moved by a round-off-signed lr_D
        # (exactly zero gradients): the GAN step's statistics rule
        _check_net(port_dis, convert.s2g_discriminator_state_dict_from_jax,
                   cast(init["dis"]), cast(_grads_of(state.dis_opt_state)),
                   cast(want["dis"]), lr_d, "discriminator",
                   STATS_TOL + (0.0 if f64 else 0.1 * 2 * lr_d))
        if f64:
            _check_net(port_gen, convert.s2g_generator_state_dict_from_jax, init["gen"],
                       _grads_of(state.gen_opt_state), want["gen"], lr, "generator")
