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
  7. the kernels' JSON line, then the device JSON as the last line

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

# seeds the kernels' inputs, the model's weights and the serving batch
SEED = 2021

K1_SOURCE = "hop_tpu_torch/csrc/reprogramming_attention.cu"
K1_REPLACES = "hop_tpu/ops/pallas_reprogramming.py:110"
K2_SOURCE = "hop_tpu_torch/csrc/gru_fused.cu"
K2_REPLACES = "hop_tpu/ops/pallas_gru_fused.py:113"


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

    K1.launches = 0
    K2.launches = 0
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
        K1.launches = 0
        K2.launches = 0
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
    model, launches = phase_serve(dev, SEED)
    phase_clips(model, dev)

    kernels = [
        {"name": "reprogramming_attention_fwd", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"], **k1},
        {"name": "gru_fused_fwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         "ms": k2[992]["ms"], "plain_ms": k2[992]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
