#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hop_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases, each ending in one line of output:

  1. device  the card's name and power limit (nvidia-smi); TF32 off
  2. build   nvcc builds csrc/*.cu for sm_90a
  3. K1      reprogramming attention kernel vs its plain version at
             (B=256, L=34, H=8, E=128, S=1500)
  4. K2      fused GRU layer kernel vs its plain version, both directions,
             at (T=34, B=256, H=350) with I=992 and I=700
  5. serve   a full-width TED HOPModel (seeded random weights) forward at
             batch 256 on the card: shape, finite, K1 launched once and K2
             four times; the first 8 samples against the same weights on
             the CPU through the plain versions; ms per forward
  6. clips   cli.test_checkpoint on 3 seeded 20 s synthetic clips at batch 1
  7. K1 bwd  the training forward (dropout 0.1, log-sum-exp) and the
             backward kernels vs their plain versions with the same mask,
             at the HOP shape; two backward calls bitwise equal
  8. K2 bwd  the forward with residuals and the backward kernels vs their
             plain versions at the head's (I=992, I=700; H=350) and the
             discriminator's (I=8, I=128; H=64) shapes; bitwise repeat
  9. train   the fused GAN step (train.llm.make_hop_train_steps) at full
             TED width, bs 256: finite losses, every trainable parameter of
             both nets moved, BERT bit-unchanged, the kernels' launches in
             one step; ms per step, the device's busy share (torch.profiler)
             and peak memory
 10. warmup  the epoch-0 warmup step at bs 8 on the card against the same
             step on the CPU (plain versions): losses and gradients
 11. the kernels' JSON line, then the device JSON as the last line

Any failed check raises, so the script exits non-zero and prints no result.
Times are CUDA-event medians (kernels, forward) or host clock around work
that ends on the host (clips).
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

# K1 reads bf16 operands; the plain version gets the same bf16-rounded
# values in f32, so only summation order and the online softmax's
# rescaling differ: f32 round-off on outputs of O(1).
K1_TOL = 1e-4
# K2 is f32 end to end; its sums run in another order than cuBLAS's and
# the difference is carried through 34 recurrent steps.
K2_TOL = 1e-4
# Card vs CPU, same weights and inputs: the frozen BERT runs its matmuls in
# bf16 (compute_bf16, unit round-off 2^-8 = 3.9e-3) on both, rounded at
# different places by the two libraries, and K1 reads bf16 operands on the
# card where the CPU's plain version reads f32. Six layers compound that
# to ~1e-2 relative on BERT's output; the f32 head maps it through weights
# of scale <= 1/sqrt(350) onto outputs of O(0.1-1).
SERVE_TOL = 2e-2

# The backwards sum many more terms in another order than the plain
# versions' cuBLAS products (K1's dk, dv over all 8704 query rows; K2's
# weight gradients over T*B = 8704 rows; both from bf16-exact or f32
# operands): their tolerance is relative, to the largest element of each
# gradient.
BWD_REL_TOL = 1e-4
# The epoch-0 warmup step, card vs CPU: as SERVE_TOL, the frozen BERT's
# bf16 matmuls round at different places on the two (and K1 reads bf16 on
# the card), now forward and backward through its six layers. Losses agree
# to TRAIN_LOSS_TOL relative; each gradient tensor to TRAIN_GRAD_TOL of its
# largest element. A tensor whose gradient stays below 1e-5 of the net's
# largest is round-off of an exactly zero gradient (a bias that BatchNorm
# or the softmax cancels) and is left out.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2

# seeds the kernels' inputs, the models' weights and the batches
SEED = 2021

K1_SOURCE = "hop_tpu_torch/csrc/reprogramming_attention.cu"
K1_REPLACES = "hop_tpu/ops/pallas_reprogramming.py:110"
K1_BWD_REPLACES = "hop_tpu/ops/pallas_reprogramming.py:130"
K2_SOURCE = "hop_tpu_torch/csrc/gru_fused.cu"
K2_REPLACES = "hop_tpu/ops/pallas_gru_fused.py:113"
K2_BWD_REPLACES = "hop_tpu/ops/pallas_gru_fused.py:202"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, TF32 off")


def phase_build():
    from hop_tpu_torch.ops import _build
    _build.load()
    print(f"build: kernels built and loaded in {_build.build_seconds:.2f} s "
          f"({_build.library_path().name})")


def phase_k1(dev, seed):
    import torch
    from hop_tpu_torch.ops import reprogramming_attention as K1
    B, L, H, E, S = 256, 34, 8, 128, 1500
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(*shape, device=dev, generator=g)
               for shape in ((B, L, H, E), (H, S, E), (H, S, E)))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    scale = E ** -0.5
    got = K1.reprogramming_attention(qb, kb, vb, scale)
    want = K1.plain_reprogramming_attention(qb.float(), kb.float(), vb.float(), scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: K1.reprogramming_attention(qb, kb, vb, scale))
    plain_ms = cuda_ms(lambda: K1.plain_reprogramming_attention(
        qb.float(), kb.float(), vb.float(), scale))
    print(f"K1 reprogramming_attention (B={B}, L={L}, H={H}, E={E}, S={S}): "
          f"max_abs_err {err:.3e} (tol {K1_TOL:g}), kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    check(err <= K1_TOL, f"K1 disagrees with its plain version: {err} > {K1_TOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_k2(dev, seed):
    import torch
    from hop_tpu_torch.ops import gru_fused as K2
    T, B, H, D = 34, 256, 350, 2
    res = {}
    for I in (992, 700):
        g = torch.Generator(device=dev).manual_seed(seed + I)
        s = H ** -0.5

        def arr(*shape, scale=s):
            return torch.randn(*shape, device=dev, generator=g) * scale
        args = (arr(T, B, I, scale=1.0), arr(D, 3, I, H), arr(D, 3, 1, H),
                arr(D, 3, H, H), arr(D, 3, 1, H), torch.zeros(B, H, device=dev))
        got = K2.gru_fused_layer(*args)
        want = K2.plain_gru_fused_layer(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: K2.gru_fused_layer(*args))
        plain_ms = cuda_ms(lambda: K2.plain_gru_fused_layer(*args), reps=10)
        print(f"K2 gru_fused_layer (T={T}, B={B}, I={I}, H={H}, D={D}): "
              f"max_abs_err {err:.3e} (tol {K2_TOL:g}), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")
        check(err <= K2_TOL, f"K2 disagrees with its plain version at I={I}: "
                             f"{err} > {K2_TOL}")
        res[I] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return res


def serving_batch(cfg, B, seed, dev):
    """Seeded synthetic windows: audio (tones over noise), log-mel computed
    on the card, sparse word ids, unit dir-vec seeds, speakers, and the
    speaker-latent noise."""
    import numpy as np
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.ops import mel as mel_ops
    d = cfg.data
    r = np.random.default_rng(seed)
    t = np.arange(d.expected_audio_length) / d.sample_rate
    audio = 0.01 * r.standard_normal((B, t.size)) + 0.2 * np.sin(
        2 * np.pi * r.uniform(100, 500, size=(B, 1)) * t)
    text = np.where(r.random((B, d.n_poses)) < 0.25,
                    r.integers(4, cfg.llm.vocab_size, size=(B, d.n_poses)), 0)
    seed_vec = r.standard_normal((B, d.n_seed_frames, d.pose_dim // 3, 3))
    seed_vec /= np.linalg.norm(seed_vec, axis=-1, keepdims=True)
    in_audio = torch.tensor(audio, dtype=torch.float32, device=dev)
    return dict(
        in_audio=in_audio,
        x_enc=mel_ops.log_mel_spectrogram(in_audio, sr=d.sample_rate,
                                          n_fft=d.mel_n_fft, hop=d.mel_hop,
                                          n_mels=d.mel_bins),
        text=torch.tensor(text, device=dev),
        pre_seq=torch.tensor(seed_vec.reshape(B, d.n_seed_frames, -1),
                             dtype=torch.float32, device=dev),
        vid_indices=torch.tensor(r.integers(0, N_SPEAKERS, size=B), device=dev),
        eps=torch.tensor(r.standard_normal((B, cfg.hop.z_size)),
                         dtype=torch.float32, device=dev),
    )


def phase_serve(dev, seed):
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import reprogramming_attention as K1
    cfg = ted_config()
    B = 256
    t0 = time.perf_counter()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed)
    model = copy.deepcopy(model_cpu).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    batch = serving_batch(cfg, B, seed, dev)
    setup_s = time.perf_counter() - t0

    def forward(b):
        with torch.inference_mode():
            return model(b["in_audio"], b["x_enc"], b["text"], b["pre_seq"],
                         b["vid_indices"], eps=b["eps"])[0]

    _reset_counts()
    out = forward(batch)
    torch.cuda.synchronize()
    launches = {"K1": K1.launches, "K2": K2.launches}
    check(tuple(out.shape) == (B, cfg.data.n_poses, cfg.data.pose_dim),
          f"forward shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "forward has non-finite values")
    check(launches == {"K1": 1, "K2": cfg.hop.gru_layers},
          f"kernel launches in one forward: {launches}, want K1 1, "
          f"K2 {cfg.hop.gru_layers}")

    n = 8
    small = {k: v[:n].cpu() for k, v in batch.items()}
    with torch.inference_mode():
        ref = model_cpu(small["in_audio"], small["x_enc"], small["text"],
                        small["pre_seq"], small["vid_indices"], eps=small["eps"])[0]
    diff = (out[:n].cpu() - ref).abs().max().item()
    check(diff <= SERVE_TOL, f"card vs CPU forward differ by {diff} > {SERVE_TOL}")
    ms = cuda_ms(lambda: forward(batch), reps=10, warmup=2)
    print(f"serve: TED HOPModel ({n_params / 1e6:.1f} M params, set up in "
          f"{setup_s:.1f} s) forward bs {B} -> {tuple(out.shape)} finite; "
          f"launches K1 {launches['K1']} K2 {launches['K2']}; card vs CPU "
          f"(first {n}) max_abs_diff {diff:.3e} (tol {SERVE_TOL:g}); "
          f"{ms:.2f} ms per forward")
    return model, launches


def phase_clips(model, dev):
    import math
    from hop_tpu_torch.cli import test_checkpoint
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import reprogramming_attention as K1
    cfg = ted_config()
    d = cfg.data
    seconds = 20.0
    unit, stride = d.n_poses / d.pose_resampling_fps, (
        d.n_poses - d.n_pre_poses) / d.pose_resampling_fps
    windows = math.ceil((seconds - unit) / stride) + 1
    frames = windows * d.n_poses - (windows - 1) * d.n_pre_poses
    times = []
    for clip_seed in (1, 2, 3):
        _reset_counts()
        t0 = time.perf_counter()
        out = test_checkpoint.main(["--device", str(dev), "--seed", str(clip_seed),
                                    "--clip-seconds", str(seconds)], model=model)
        times.append(time.perf_counter() - t0)
        check(out.shape == (frames, d.pose_dim), f"clip {clip_seed}: {out.shape}")
        check(K1.launches == windows
              and K2.launches == cfg.hop.gru_layers * windows,
              f"clip {clip_seed}: launches K1 {K1.launches} K2 {K2.launches}")
    print(f"clips: 3 x {seconds:.0f} s synthetic clips at bs 1 -> {frames} frames "
          f"each ({windows} windows); seconds per clip "
          f"{', '.join(f'{t:.3f}' for t in times)}")


def rel_err(got, want) -> tuple:
    """(max abs error, that error over the largest |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def phase_k1_bwd(dev, seed):
    import torch
    from hop_tpu_torch.ops import reprogramming_attention as K1
    B, L, H, E, S = 256, 34, 8, 128, 1500
    rate, drop_seed = 0.1, 1234
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q, do = (torch.randn(B, L, H, E, device=dev, generator=g) for _ in range(2))
    k, v = (torch.randn(H, S, E, device=dev, generator=g) for _ in range(2))
    # the kernels read bf16: give the plain versions the same values
    q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    scale = E ** -0.5
    args = (scale, rate, drop_seed)
    out, lse = K1.reprogramming_attention_fwd(q, k, v, *args, with_lse=True)
    want_out, want_lse = K1.plain_reprogramming_attention(q, k, v, *args,
                                                          with_lse=True)
    got = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *args)
    again = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *args)
    want = K1.plain_reprogramming_attention_bwd(q, k, v, want_out, want_lse,
                                                do, *args)
    torch.cuda.synchronize()
    out_err = max((out - want_out).abs().max().item(),
                  (lse - want_lse).abs().max().item())
    check(out_err <= K1_TOL, f"K1 training forward: {out_err} > {K1_TOL}")
    errs = {}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        check(torch.equal(a, b), f"K1 bwd: {name} differs between two calls")
        errs[name] = rel_err(a, c)
        check(errs[name][1] <= BWD_REL_TOL,
              f"K1 bwd {name}: {errs[name][1]} > {BWD_REL_TOL} relative")
    fwd_ms = cuda_ms(lambda: K1.reprogramming_attention_fwd(
        q, k, v, *args, with_lse=True), reps=10)
    fwd_plain_ms = cuda_ms(lambda: K1.plain_reprogramming_attention(
        q, k, v, *args, with_lse=True), reps=5)
    ms = cuda_ms(lambda: K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *args),
                 reps=10)
    plain_ms = cuda_ms(lambda: K1.plain_reprogramming_attention_bwd(
        q, k, v, want_out, want_lse, do, *args), reps=5)
    print(f"K1 bwd (B={B}, L={L}, H={H}, E={E}, S={S}, rate {rate}): training "
          f"forward out/lse max_abs_err {out_err:.3e} (tol {K1_TOL:g}), "
          + ", ".join(f"{n} max_abs_err {e[0]:.3e} rel {e[1]:.2e}"
                      for n, e in errs.items())
          + f" (tol {BWD_REL_TOL:g} rel); bitwise repeat; forward kernel "
          f"{fwd_ms:.3f} ms vs plain {fwd_plain_ms:.3f} ms; backward kernel "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return {"max_abs_err": max(e[0] for e in errs.values()), "ms": ms,
            "plain_ms": plain_ms, "out_err": out_err}


def phase_k2_bwd(dev, seed):
    import torch
    from hop_tpu_torch.ops import gru_fused as K2
    res = {}
    for T, B, I, H in ((34, 256, 992, 350), (34, 256, 700, 350),
                       (28, 256, 8, 64), (28, 256, 128, 64)):
        D = 2
        g = torch.Generator(device=dev).manual_seed(seed + I + H)
        s = H ** -0.5

        def arr(*shape, scale=s):
            return torch.randn(*shape, device=dev, generator=g) * scale
        args = (arr(T, B, I, scale=1.0), arr(D, 3, I, H), arr(D, 3, 1, H),
                arr(D, 3, H, H), arr(D, 3, 1, H), torch.zeros(B, H, device=dev))
        dout = arr(D, T, B, H, scale=1.0)
        fwd = K2.gru_fused_layer_fwd(*args, with_residuals=True)
        want_fwd = K2.plain_gru_fused_layer(*args, with_residuals=True)
        torch.cuda.synchronize()
        fwd_err = max((a - b).abs().max().item() for a, b in zip(fwd, want_fwd))
        check(fwd_err <= K2_TOL, f"K2 forward with residuals at I={I}, H={H}: "
                                 f"{fwd_err} > {K2_TOL}")
        h_seq, r, z, n, hnb = fwd
        bwd_args = (dout, args[0], r, z, n, hnb, K2.hprev_of(h_seq, args[5]),
                    args[1], args[3])
        got = K2.gru_fused_layer_bwd(*bwd_args)
        again = K2.gru_fused_layer_bwd(*bwd_args)
        want = K2.plain_gru_fused_layer_bwd(*bwd_args)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b, c in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"),
                                 got, again, want):
            check(torch.equal(a, b), f"K2 bwd at I={I}: {name} differs between "
                                     f"two calls")
            errs[name] = rel_err(a, c)
            check(errs[name][1] <= BWD_REL_TOL,
                  f"K2 bwd at I={I}, H={H} {name}: {errs[name][1]} > "
                  f"{BWD_REL_TOL} relative")
        ms = cuda_ms(lambda: K2.gru_fused_layer_bwd(*bwd_args), reps=10)
        plain_ms = cuda_ms(lambda: K2.plain_gru_fused_layer_bwd(*bwd_args), reps=5)
        fwd_ms = cuda_ms(lambda: K2.gru_fused_layer_fwd(*args, with_residuals=True),
                         reps=10)
        worst = max(errs, key=lambda k: errs[k][1])
        print(f"K2 bwd (T={T}, B={B}, I={I}, H={H}, D={D}): forward with "
              f"residuals max_abs_err {fwd_err:.3e} (tol {K2_TOL:g}), "
              f"{fwd_ms:.3f} ms; backward worst {worst} rel "
              f"{errs[worst][1]:.2e} (tol {BWD_REL_TOL:g}), max_abs_err "
              f"{max(e[0] for e in errs.values()):.3e}; bitwise repeat; "
              f"backward kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms")
        res[(I, H)] = {"max_abs_err": max(e[0] for e in errs.values()), "ms": ms,
                       "plain_ms": plain_ms, "fwd_err": fwd_err}
    return res


def _launch_counts():
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import reprogramming_attention as K1
    return {"K1": K1.launches, "K1_bwd": K1.bwd_launches, "K2": K2.launches,
            "K2_bwd": K2.bwd_launches}


def _reset_counts():
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import reprogramming_attention as K1
    K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0


def _trainable(module):
    return {k: p for k, p in module.named_parameters() if p.requires_grad}


def _busy_share(step, n: int, ms_per_step: float):
    """Kernel time on the card over n profiled steps, per step, over the
    unprofiled ms per step; and the five kernels that took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return device_ms / ms_per_step, device_ms, [
        (e.key[:60], e.self_device_time_total / 1e3 / n) for e in top]


def phase_train(dev, seed):
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.data.synthetic import make_train_batch
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.train.llm import make_hop_train_steps
    cfg = ted_config()
    B = cfg.train.batch_size
    t0 = time.perf_counter()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed)
    disc_cpu = build_discriminator(cfg, seed + 1)
    model = copy.deepcopy(model_cpu).to(dev)
    disc = copy.deepcopy(disc_cpu).to(dev)
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    state = init_state()
    batch = make_train_batch(cfg, B, seed, N_SPEAKERS, dev)
    setup_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in
              list(model.state_dict().items()) + [("D." + k, v) for k, v in
                                                  disc.state_dict().items()]}
    noise_gen = torch.Generator().manual_seed(seed)

    _reset_counts()
    state, metrics = gan(state, batch, noise_gen)
    torch.cuda.synchronize()
    launches = _launch_counts()
    head, d_layers = cfg.hop.gru_layers, disc.gru.num_layers
    want = {"K1": 1, "K1_bwd": 1,
            # head with residuals + the shuffled-speaker head (lean) + the
            # discriminator's three forwards (G term, real, fake)
            "K2": 2 * head + 3 * d_layers, "K2_bwd": head + 3 * d_layers}
    check(launches == want, f"kernel launches in one GAN step: {launches}, "
                            f"want {want}")
    for k, v in metrics.items():
        check(bool(torch.isfinite(v)), f"train metric {k} = {v.item()}")
    # gwnet's last layer feeds only the residual path that its output does
    # not read (as in the reference): its GCN and BatchNorm get no gradient
    last = f"{len(model.gwnet.bn) - 1}."
    unused = {f"gwnet.{m}.{last}{w}" for m in ("gconv", "bn") for w in
              ("weight", "bias", "mlp.mlp.weight", "mlp.mlp.bias")}
    no_grad = []
    for name, module, prefix in (("generator", model, ""), ("discriminator", disc, "D.")):
        for k, p in _trainable(module).items():
            if p.grad is None:
                no_grad.append(prefix + k)
                continue
            check(not torch.equal(p.detach(), before[prefix + k]),
                  f"{name} parameter {k} did not move")
    check(set(no_grad) <= unused, f"parameters without a gradient: {no_grad}")
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(frozen and all(k.startswith("llm_model.") for k in frozen),
          f"frozen parameters: {frozen[:3]}...")
    for k in frozen:
        check(torch.equal(model.state_dict()[k], before[k]), f"frozen {k} changed")

    def step():
        nonlocal state
        state, _ = gan(state, batch, noise_gen)
    ms = cuda_ms(step, reps=10, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    busy, device_ms, top = _busy_share(step, 3, ms)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_train = sum(p.numel() for p in _trainable(model).values())
    print(f"train: fused GAN step, TED full width, bs {B} (set up in "
          f"{setup_s:.1f} s; {n_train / 1e6:.1f} M trainable generator "
          f"params): losses finite ("
          + ", ".join(f"{k} {metrics[k].item():.4g}" for k in
                      ("loss", "KLD", "DIV_REG", "gen", "dis"))
          + f"); every trainable param of both nets with a gradient moved "
          f"({len(no_grad)} without one: gwnet's last GCN and BatchNorm), BERT "
          f"unchanged; "
          f"launches {launches}; {ms:.2f} ms per step (CUDA-event median of "
          f"10); kernels {device_ms:.2f} ms per step, busy share {busy:.3f} "
          f"(torch.profiler, 3 steps); peak memory {peak_gb:.2f} GiB")
    print("train: top kernels per step: " + "; ".join(
        f"{name} {t:.2f} ms" for name, t in top))
    return model_cpu, disc_cpu, launches


def phase_warmup_vs_cpu(model_cpu, disc_cpu, dev, seed):
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.data.synthetic import make_train_batch
    from hop_tpu_torch.train.llm import StepNoise, make_hop_train_steps
    cfg = ted_config()
    B = 8
    batch = make_train_batch(cfg, B, seed + 2, N_SPEAKERS)
    noise = StepNoise.draw(torch.Generator().manual_seed(seed + 2), cfg, B)
    runs = []
    for device in (dev, torch.device("cpu")):
        model = copy.deepcopy(model_cpu).to(device)
        disc = copy.deepcopy(disc_cpu).to(device)
        warmup, _, init_state = make_hop_train_steps(cfg, model, disc)
        _, metrics = warmup.for_epoch(0)(
            init_state(), {k: v.to(device) for k, v in batch.items()}, noise)
        grads = {k: p.grad.cpu() for k, p in _trainable(model).items()
                 if p.grad is not None}
        runs.append(({k: v.item() for k, v in metrics.items()}, grads))
    (m_card, g_card), (m_cpu, g_cpu) = runs
    loss_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                   for k in ("loss", "KLD", "DIV_REG"))
    check(loss_err <= TRAIN_LOSS_TOL, f"warmup step card vs CPU losses: "
                                      f"{loss_err} > {TRAIN_LOSS_TOL} relative")
    zero = 1e-5 * max(g.abs().max().item() for g in g_cpu.values())
    errs = {k: rel_err(g_card[k], g)[1] for k, g in g_cpu.items()
            if g.abs().max().item() >= zero}
    worst = sorted(errs, key=lambda k: -errs[k])[:3]
    check(errs[worst[0]] <= TRAIN_GRAD_TOL,
          f"warmup step card vs CPU gradients: {worst[0]} {errs[worst[0]]} > "
          f"{TRAIN_GRAD_TOL}")
    print(f"warmup: epoch-0 warmup step bs {B}, card vs CPU: losses rel err "
          f"{loss_err:.2e} (tol {TRAIN_LOSS_TOL:g}); gradients of "
          f"{len(errs)}/{len(g_cpu)} tensors (the rest are round-off of exact "
          f"zeros), worst rel err " + ", ".join(
              f"{k} {errs[k]:.2e}" for k in worst) + f" (tol {TRAIN_GRAD_TOL:g})")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hop_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)

    phase_device()
    phase_build()
    k1 = phase_k1(dev, SEED)
    k2 = phase_k2(dev, SEED)
    model, _ = phase_serve(dev, SEED)
    phase_clips(model, dev)
    del model
    k1_bwd = phase_k1_bwd(dev, SEED)
    k2_bwd = phase_k2_bwd(dev, SEED)
    model_cpu, disc_cpu, launches = phase_train(dev, SEED)
    phase_warmup_vs_cpu(model_cpu, disc_cpu, dev, SEED)

    # launches: one fused GAN step (phase 9); errors: every comparison of
    # that kernel with its plain version in this run
    kernels = [
        {"name": "reprogramming_attention_fwd", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"],
         "max_abs_err": max(k1["max_abs_err"], k1_bwd["out_err"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "reprogramming_attention_bwd", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_BWD_REPLACES,
         "launches": launches["K1_bwd"], "max_abs_err": k1_bwd["max_abs_err"],
         "ms": k1_bwd["ms"], "plain_ms": k1_bwd["plain_ms"]},
        {"name": "gru_fused_fwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"],
         "max_abs_err": max([r["max_abs_err"] for r in k2.values()]
                            + [r["fwd_err"] for r in k2_bwd.values()]),
         "ms": k2[992]["ms"], "plain_ms": k2[992]["plain_ms"]},
        {"name": "gru_fused_bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_BWD_REPLACES, "launches": launches["K2_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_bwd.values()),
         "ms": k2_bwd[(992, 350)]["ms"], "plain_ms": k2_bwd[(992, 350)]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
