#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hop_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases, each ending in one line of output:

  1. device  the card's name and power limit (nvidia-smi); TF32 off
  2. build   nvcc builds csrc/*.cu for sm_90a
  3. K1      reprogramming attention forward kernel vs its plain version at
             (B=256, L=34, H=8, E=128, S=1500), B=250 (a ragged row tile) and
             B=1 (S split across blocks), rate 0 and 0.1 with the log-sum-exp
             and the plain version's mask; bitwise repeat; only its own
             kernels between the wrapper's entry and exit
  4. K2      fused GRU layer forward vs its plain version, lean and with
             residuals, a non-zero h0, at the head's (T=34, B=256, H=350; I=992
             and 700, and 4320 on the LLaMA backbone) and the discriminator's
             (T=28, H=64; I=8 and 128) shapes,
             B=250, B=1 and one direction; bitwise repeat; the projection
             kernel's and the recurrence kernel's ms (torch.profiler) beside
             the whole
  5. serve   a full-width TED HOPModel (seeded random weights) forward at
             batch 256 on the card: shape, finite, K1 launched once and K2
             four times; the first 8 samples against the same weights on
             the CPU through the plain versions; ms per forward
  6. clips   cli.test_checkpoint on 3 seeded 20 s synthetic clips at batch 1
  7. K1 bwd  the training forward (dropout 0.1 and 0, log-sum-exp) and the
             backward kernels, fed that forward's out and lse, vs their plain
             versions with the same mask, at the HOP shape, B=250 (a ragged
             row tile) and B=1; two backward calls bitwise equal; the dq
             kernel's, the dk/dv kernel's and the run combine's ms
  8. K2 bwd  the forward with residuals and the backward kernels vs their
             plain versions at the head's (I=992, I=700, I=4320; H=350) and the
             discriminator's (I=8, I=128; H=64) shapes; bitwise repeat; the
             forward's recurrence kernel's ms; the backward's recurrence's,
             each GEMM's, the slice reduce's and the column sums' ms; the
             wrapper's workspace size against the C entry's
  9. train   the fused GAN step (train.llm.make_hop_train_steps) at full
             TED width, bs 256: finite losses, every trainable parameter of
             both nets moved, BERT bit-unchanged, the kernels' launches in
             one step; ms per step, the device's busy share (torch.profiler)
             and peak memory. Then the same step on the GRU's stack route
 10. warmup  the epoch-0 warmup step at bs 8 on the card against the same
             step on the CPU (plain versions): losses and gradients
 11. K3 fwd  the time-grid GRU recurrence kernel vs its plain version, with
             residuals and lean, f32 and bf16 streams, a non-zero h0, at the
             head's (D=2, T=34, B=256, H=350) and the discriminator's
             (T=28, H=64) shapes, B=250 (a ragged tile) and D=1; the kernel's
             own ms (the cluster or the one-block kernel, by name)
 12. K3 bwd  its backward from the forward's residuals at both shapes, f32
             and bf16 streams: every output, dh0 too; bitwise repeat; the
             forward's recurrence kernel's ms, the backward's recurrence's
             and the dW_hh product's ms
 13. K6      the sequence kernel vs its plain version, both directions, at
             the head's layer (B=256 and B=1, H=350: the cluster) and at
             H=64 (the one-block kernel); bitwise repeat, launches counted,
             the recurrence kernel's own ms (torch.profiler) beside the call,
             the plain version and the bound; `gru_forward_seq` on the head's
             parameters against the same GRU through K2
 14. serve, stack route   phase 5's forward with gru_kernel="stack": K3 lean
             four times and K2 not at all, output against the fused route's
             on the same weights; then phase 6's clips on that route
 15. train, 3-forward step on the stack route   host batches (numpy) over
             the int16 wire through cli.common.device_batch; two warmup and
             three GAN steps at full TED width, bs 256: phase 9's checks
             and measurements, launches as derived from the step's structure
 16. warmup, 3-forward, stack route   phase 10 for that step and route
 17. library yardsticks (timed here, never called by the port): one
             bidirectional torch.nn.GRU layer on cuDNN beside both routes'
             layer, forward and forward + backward, at the head's (I = 992,
             700 and, on LLaMA, 4320) and the discriminator's shapes;
             F.scaled_dot_product_attention on K1's
             shape at rate 0, forward and backward (held to K1's backward),
             and on K4's and K5's, forward and backward, each also by its
             kernels' own time (torch.profiler) and over 50 calls a pair of
             CUDA events
 18. K4, K5  the backbone's self-attention kernels vs their plain versions,
             forward (rate 0 and 0.1, the same mask) and backward (rate 0.1),
             at (B=256, T=34, H=12, D=64), B=1 and B=250 (a ragged last
             group); K5 against K4; K5 in groups of 1, 2 and 4; bitwise
             repeat; each kernel's own time (torch.profiler, only its own
             kernel in the call) and its time over 50 calls a pair of CUDA
             events, beside the event time of one call
 19. serve, kernel attention   phase 14's model with the backbone's attention
             switched to "fused" (K4) and "block" (K5): the bs-256 forward
             against the plain route's, launches, ms per forward of all three
             routes; one 20 s clip at bs 1 on each
 20. train, kernel attention   the fused GAN step on the stack route at full
             TED width, bs 256, with "fused" and with "block": phase 9's checks
             and measurements; then phase 10 on the block route; then phase
             15's 3-forward step with "fused" and with "block"
 21. eval    the validation pass at full TED width: 20 seeded 20 s synthetic
             source clips through the preprocessor into a record store
             (>= 513 windows), the native gather held bitwise to the numpy
             gather, `SpeechMotionDataset` batches of 256 (the last ragged)
             through `device_batch`, the HOPModel forward and
             `evaluate_testset` (L1, joint MAE, FGD, feature distance, BC,
             diversity) at epoch bc_start_epoch + 1, on the fused and the
             stack GRU route with plain attention and on the stack route
             with fused (K4) and block (K5) attention: finite results,
             diversity > 0, launches as derived; the same metric functions
             on the CPU fed the card's generated poses, targets, audio and
             speaker ids agree; the onset masks are equal; seconds to
             preprocess, ms per make_batch, device_batch, forward and
             metrics pass, the onset detector beside its FFT bound and
             torch.stft's power spectrogram, FGD on the pass's features,
             seconds per pass
 22. run     the training entry point as a user runs it, `python -m
             hop_tpu_torch.cli.run_ted` (its `main`), at full TED width, bs
             256, the default routes, on 20 seeded 20 s synthetic clips (2
             steps an epoch, one validation batch), the GAN gate open from
             epoch 1: run A trains 4 epochs with prefetch 0; run B trains 2
             with prefetch 2 and `--transfer-guard disallow` (no hidden wait
             for the card in the hot loop), then resumes to 4: their last
             checkpoints are equal in every tensor, their metrics.jsonl and
             best_metrics.json files are equal, the frozen backbone is the
             seed's init, and A's launches are those derived from its steps
             and validation batches; s per epoch, steps per second at
             prefetch 0 and 2, s per validation pass, the checkpoint's size,
             save and restore s, and the busy share over one epoch; then
             cuDNN held to its deterministic algorithms (as the training
             entry point sets it on the card) against cuDNN free to pick:
             whether one epoch from the same state repeats bit for bit,
             with TF32 off (as this script runs) and as torch sets it, and
             the ms of a GAN step under each, in turns (host clock, and
             its kernels' device time)
 23. import  the same 20 seeded 20 s clips as the reference's LMDBs: a source
             LMDB (one video dict a value, `data.arrow_legacy.serialize`,
             `data.lmdbfile.write_lmdb`) and a cache LMDB of its windows;
             `python -m hop_tpu_torch.data.import_ted` (its `main`) on the
             source, on it with --verify (the log-mel recomputed on the card
             with TF32 off against the stored spectrograms), on the cache
             (--src-kind cache) and with --dry-import: every import byte-equal
             to the records the preprocessor writes from the clips; the
             decode rate, the import seconds, the verify's max |Δ| dB; then
             `run_ted` at full TED width, bs 256, 2 epochs on the imported
             records with a fabricated fastText .bin as --wordembed-path:
             launches as derived, finite metrics, the vocabulary's vectors
             the .bin's, s per epoch and the busy share over one epoch more;
             then `test_checkpoint --data <source LMDB> --clip-index 3
             --checkpoint-dir <that run>` on both GRU routes, bitwise the
             output of `generate_long_form` called with the same clip, seed
             pose, weights and generator, launches as derived
 24. llama  the TED config on LLaMA-7B's backbone (dim 4096, 32 heads, MLP
             11008, vocab 32000, 6 layers; the head's first GRU layer I =
             4320), built once on the host from the seed: the bs-256 forward
             on both GRU routes (shape, finite, launches, route vs route), its
             first 2 samples against the same weights on the CPU, ms per
             forward, the backbone's share of its kernels (torch.profiler) and
             its bf16 rate; a 20 s clip at bs 1 through generate_long_form; a
             fabricated HF checkpoint at the full width (bf16, two safetensors
             shards + index, and a pytorch_model.bin, the port's writer)
             installed by `install_llm_weights`, each bitwise the forward with
             the same weights copied in directly, MiB/s; the fused GAN step at
             bs 256 (phase 9's checks and measurements, the backbone
             bit-unchanged); then `run_ted --llm-model LLAMA --llm-layers 2
             --llm-weights <the shards>` (4096 wide; one shard of two opened)
             2 epochs against 1 + `--resume` to 2, bit for bit, a resume
             without --llm-weights refused, and `test_checkpoint
             --checkpoint-dir` on the run's checkpoint
 25. zoo    the baseline zoo (ROADMAP M13a) at its published widths (hidden
             300, 4 layers, bs 256): K2 forward and backward at each of its
             layer shapes (PoseGenerator's I = 108 / 207 / 600 at H = 300, the
             seq2seq encoder's T = 36, PoseDecoderGRU's I = 64, ContextEncoder's
             GRU(256) in one direction) and K3 at its recurrences, against
             their plain versions at K2_TOL / K3_TOL (backward BWD_REL_TOL),
             bitwise repeat, ms, their kernels' own ms, the plain version's,
             the bound and cuDNN's torch.nn.GRU at the same shape; records of
             20 seeded 20 s clips (TED and Expressive); the trimodal GAN
             (multimodal_context) on both GRU routes: a warmup and a GAN step
             at bs 8 on the card against the same steps on the CPU from the
             same state (losses, gradients; a planted fault must fail the
             limits), and at bs 256 with launches as derived from the nets;
             one bs-256 step of seq2seq, speech2gesture, joint_embedding and
             gesture_autoencoder (TED's EmbeddingNet, Expressive's MotionAE),
             and seq2seq's with torch's embedding backward (a yardstick);
             each with ms a step (CUDA events), its kernels' ms and the busy
             share (torch.profiler); `run_ted --model multimodal_context` and
             `--model seq2seq`, 2 epochs against 1 + `--resume` to 2 under
             `--transfer-guard disallow`, bit for bit, launches as derived;
             `run_expressive --model multimodal_context`, 1 epoch
 26. expressive  HOP on TED Expressive (ROADMAP M12) at its published widths
             (the head's first GRU layer 1751 wide, gwnet on 42 nodes), bs
             256: the forward, the fused GAN step on both GRU routes (ms,
             kernels' ms, busy share, peak GiB), the warmup and GAN steps at
             bs 8 on the card against the CPU (limits a planted fault must
             fail, the gradients' and the losses'; the bf16-fed tensors and
             the discriminator held apart), `run_expressive --model AD_LLM`
             2 epochs against 1 + `--resume` under `--transfer-guard
             disallow`, bit for bit; HOP's ablations on TED
             (`use_gwnet=False`, `use_reprogramming=False`): the forward,
             one fused GAN step, the warmup step against the CPU
 27. hierarchy  HA2G (ROADMAP M13b): K2 at the cascade's new first-layer
             shapes (I = 96, 102, 105, 111, 117, 147, 177 at H = 300) as in
             phase 25; the TED (3 stages) and Expressive (6 stages) warmup
             and GAN steps at bs 256 (the GAN step also on the stack route)
             with launches as derived (ms, kernels' ms, busy share, peak GiB,
             top kernels), both at bs 8 against the CPU with a planted fault
             that both limits catch, the ResNetSE's gradients against the
             same step in f64 on the CPU (HIER_AUDIO); `run_ted` and
             `run_expressive --model hierarchy` 2 epochs against 1 + `--resume`
             under `--transfer-guard disallow`, bit for bit; `train_h36m_ae`
             on a fabricated Human3.6M npz, `export_eval_net`, and a `run_ted
             --eval-net` on the export that reports a trained feature net
 28. export  the serving export (ROADMAP M17): the phase 5 model (TED at
             full width, seed 2021) exported by `infer.export_forward`
             (torch.export, weights inside; K1-K5's forwards registered as
             `torch.ops.hop_tpu_torch.*`) at bs 1 and 256 on the fused GRU
             route with plain attention and at bs 1 on the stack route with
             K4 and with K5; each artifact's MB and export s, then each
             loaded by `infer.load_exported` in a fresh python3 that imports
             hop_tpu_torch.infer alone (no hop_tpu_torch.models module may
             load) and run on the eager forward's inputs and eps: within
             EXPORT_TOL of it, launches K1 1 and K2 4 or K3 lean 4 (+ K4 or
             K5 6) read in that process, the registered ops in the graph; an
             artifact exported with K1 swapped for its plain version must be
             rejected by the same checks; the bs-256 forward eager vs loaded
             (CUDA-event medians of 10) and a 20 s clip at bs 1 through
             `generate_long_form` on each (host clock, equal frames); `run_ted
             --tensorboard-dir` 2 epochs at full width, its event file read
             back by a reader here (every metrics.jsonl row, its step, its
             value in f32); `python -m hop_tpu_torch.cli.export_model` on that
             run's checkpoint, its artifact run; `test_checkpoint
             --render-video` on a 20 s clip (seconds, writer, bytes)
 29. parallel  the parallel path (ROADMAP M15): K4 and K5 at the backbone's
             heads on a rank of a model group of 2 and 4 (H = 6, 3), K1 and K2
             at a rank's rows at data = 2 and 4 (B = 128, 64), forward and
             backward, rate 0 and 0.1, against their plain versions, with ms,
             plain ms, bound and the library call's ms; world size 1 over
             NCCL in this process: 2 fused GAN steps at bs 256 through
             `init_distributed` and the rank's optimizer, bitwise the
             one-process steps; world size 2 (`python3 chip_smoke.py --rank`,
             gloo with both ranks on this card, or NCCL where there are two):
             2 fused GAN steps at global bs 256 against the one-process steps
             (dropout off, the backbone in f32) within limits a planted fault
             (the head's GRU output x 1.001) exceeds, ZeRO against --no-zero2
             bitwise, each rank's launches, ms a step, kernels' ms, busy share
             and peak GiB on phase 9's step; model = 2 on phase 24's LLaMA-7B
             backbone (6 layers): the bs-256 forward and one fused GAN step
             against model = 1 within phase 24's limits, each rank's peak
             GiB; `run_ted --data-parallel 2` at full TED width, 2 epochs
             against 1 + `--resume`, bit for bit
 30. parallel hierarchy   the hierarchy (HA2G, ROADMAP M15b) on a split
             batch: K2 and K3 at a rank's rows (B = 128) of the stages' first
             layer and of the discriminator's, forward and backward, against
             their plain versions, with ms, plain ms, bound and cuDNN's ms;
             world size 1 over NCCL in this process: 2 GAN steps of the TED
             hierarchy at published widths, bs 256, on the fused route,
             bitwise the one-process steps; world size 2 (`python3
             chip_smoke.py --rank`, gloo with both ranks on this card, or
             NCCL where there are two): 2 GAN steps at global bs 256 against
             the one-process steps (dropout off) within limits that three
             planted faults exceed (the last stage's GRU output x 1.001; the
             contrastive terms over a rank's own pairs alone; the audio
             encoder's BatchNorms over a rank's own rows), ZeRO against
             --no-zero2 bitwise, each rank's launches, ms a step, kernels'
             ms, busy share and peak GiB; `run_ted --model hierarchy
             --data-parallel 2` at full TED width, 2 epochs against 1 +
             `--resume`, bit for bit
 31. the kernels' JSON line, then the device JSON as the last line

Any failed check raises, so the script exits non-zero and prints no result.
Times are CUDA-event medians (kernels, forward) or host clock around work
that ends on the host (clips). A kernel's `bound_ms` is the least time an
H100 SXM could take for the call: the larger of its operand and result
bytes over 3.35 TB/s and its operations over the peak for their type
(67 TFLOP/s f32 outside the tensor cores, 989 TFLOP/s bf16).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import math
import os
import statistics
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types

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

# K3 and K6 are f32 recurrences like K2's: sums in another order than the
# plain version's cuBLAS products, carried through up to 34 steps.
K3_TOL = 1e-4
# K3's stream gradients in bf16: kernel and plain version round f32 values
# that differ in round-off, so an element may land on the next bf16 value
# (2^-8 relative): relative to each tensor's largest element.
K3_BF16_DX_TOL = 1e-2
# The fused and the stack route on the same weights: four f32 GRU layers,
# each within K2_TOL-scale round-off of the other route's (the projection
# summed by cuBLAS or inside K2), compounding through the stack.
ROUTE_TOL = 5e-4
# the yardstick computes K1's function: its bf16 output (2^-8 relative
# rounding of values of O(1)) against the kernel's f32 output
SDPA_TOL = 2e-2

# the yardstick's gradients leave it in bf16 (2^-8 relative rounding), its
# P and dS meet the tensor cores as single bf16 values, and dk, dv sum 8704
# query rows: relative to each gradient's largest element
SDPA_BWD_REL_TOL = 2e-2

# K4's results leave the kernel in bf16: one rounding (2^-8 relative) of
# outputs up to ~4, of values the plain version holds in f32; its gradients
# likewise, relative to each gradient's largest element.
K4_TOL = 2e-2
K4_BWD_REL_TOL = 1e-2
# K5's results are f32; both sides read the same bf16-rounded operands, and
# the probabilities and dS enter K5's tensor-core products as hi + lo bf16
# pairs (2^-17 relative): what is left is f32 summation order.
K5_TOL = 1e-4
# The backbone on a kernel route against its plain route, same weights: the
# plain route softmaxes in bf16 and rounds the probabilities to bf16
# (compute_bf16), the kernels softmax in f32: a difference of SERVE_TOL's
# kind (bf16 round-off through six layers), not of ROUTE_TOL's.
ATTN_ROUTE_TOL = 2e-2

# seeds the kernels' inputs, the models' weights and the batches
SEED = 2021

# peaks of one H100 SXM (NVIDIA's data sheet, dense): the bounds' rooflines
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # outside the tensor cores
BF16_FLOPS = 989e12        # tensor cores, bf16 operands

K1_SOURCE = "hop_tpu_torch/csrc/reprogramming_attention.cu"
K1_REPLACES = "hop_tpu/ops/pallas_reprogramming.py:110"
K1_BWD_REPLACES = "hop_tpu/ops/pallas_reprogramming.py:130"
K2_SOURCE = "hop_tpu_torch/csrc/gru_fused.cu"
K2_REPLACES = "hop_tpu/ops/pallas_gru_fused.py:113"
K2_BWD_REPLACES = "hop_tpu/ops/pallas_gru_fused.py:202"
K3_SOURCE = "hop_tpu_torch/csrc/gru_stack.cu"
K3_REPLACES = "hop_tpu/ops/pallas_gru_stack.py:46"
K3_LEAN_REPLACES = "hop_tpu/ops/pallas_gru_stack.py:73"
K3_BWD_REPLACES = "hop_tpu/ops/pallas_gru_stack.py:168"
K6_SOURCE = "hop_tpu_torch/csrc/gru_seq.cu"
K6_REPLACES = "hop_tpu/ops/pallas_gru.py:36"
K4_SOURCE = "hop_tpu_torch/csrc/attention.cu"
K4_REPLACES = "hop_tpu/ops/pallas_attention.py:126"
K4_BWD_REPLACES = "hop_tpu/ops/pallas_attention.py:137"
K5_SOURCE = "hop_tpu_torch/csrc/block_attention.cu"
K5_REPLACES = "hop_tpu/ops/pallas_block_attention.py:127"
K5_BWD_REPLACES = "hop_tpu/ops/pallas_block_attention.py:150"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3, setup=None) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls.
    With `setup`, each call is fn(setup()) and only fn is timed."""
    import torch
    call = fn if setup is None else (lambda: fn(setup()))
    for _ in range(warmup):
        call()
    times = []
    for _ in range(reps):
        arg = () if setup is None else (setup(),)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _flat(tensors):
    for t in tensors:
        if isinstance(t, (tuple, list)):
            yield from _flat(t)
        elif hasattr(t, "element_size"):
            yield t


def bound(operands, results, flops: float, peak: float) -> dict:
    """The least time the card could take for a call: its operands read once
    and its results written once at the memory rate, or `flops` at `peak`."""
    nbytes = sum(t.numel() * t.element_size() for t in _flat([operands, results]))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device():
    import torch
    smi = _smi()
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


def kernel_ms_by_name(fn, n: int = 10) -> dict:
    """Each kernel's device time per call of fn(), by name (torch.profiler,
    checked by count: `hop_tpu_torch.cli.time_kernels.kernel_ms_by_name`)."""
    from hop_tpu_torch.cli.time_kernels import kernel_ms_by_name as by_name
    return by_name(fn, n)


def own_ms(fn, what: str, n: int = 10) -> tuple:
    """(ms, names): the device time of all kernels one call of fn()
    launches (torch.profiler), and their names; (None, []) when the profiler
    recorded nothing, which is said on a line of its own."""
    names = kernel_ms_by_name(fn, n)
    if not names:
        print(f"{what}: torch.profiler recorded no window whole in six; its own "
              f"time is not recorded")
        return None, []
    return sum(names.values()), sorted(names)


def fmt_ms(x) -> str:
    """A measured ms to four places, or "not recorded"."""
    return "not recorded" if x is None else f"{x:.4f}"


def loop_ms(fn, n: int = 50) -> float:
    """ms per call of n calls of fn() between one pair of CUDA events, after
    a warm-up call: the card runs one call while the host launches the
    next, so this is the larger of the two rates."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def fwd_kernel_name(H: int) -> str:
    """The forward recurrence kernel's name at hidden width H."""
    from hop_tpu_torch.ops.gru_fused import recurrence_variant
    return f"gru_fwd_{recurrence_variant(H)}_kernel"


def ms_of(names: dict, part: str) -> float:
    """ms per call of the kernels whose name holds `part`."""
    return sum(t for n, t in names.items() if part in n)


def gemm_ms(names: dict, k_rows: bool) -> float:
    """ms per call of the backward GEMM's instances whose operands' rows run
    along k (dx) or whose row index is k (dW_ih, dW_hh): the kernel's third
    template argument."""
    import re
    total = 0.0
    for name, t in names.items():
        m = re.search(r"gru_mma_gemm_kernel<([^>]*)>", name)
        if m and (m.group(1).split(",")[2].strip().replace("(bool)", "")
                  in ("true", "1")) == k_rows:
            total += t
    return total


# (B, L, H, S) of K1's forward: the HOP batch, a ragged last row tile, and one
# window of a long-form clip (too few row tiles for the card: the key splits)
K1_SHAPES = ((256, 34, 8, 1500), (250, 34, 8, 1500), (1, 34, 8, 1500))


def phase_k1(dev, seed):
    import torch
    from hop_tpu_torch.ops import reprogramming_attention as K1
    E = K1.HEAD_DIM
    scale, drop_seed = E ** -0.5, 1234
    res = {}
    for B, L, H, S in K1_SHAPES:
        g = torch.Generator(device=dev).manual_seed(seed + B)
        qb, kb, vb = (torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)
                      for shape in ((B, L, H, E), (H, S, E), (H, S, E)))
        splits = K1.split_count(B, L, H, S)
        check((splits > 1) == (B == 1), f"K1 at B={B}: {splits} key splits")
        err = 0.0
        for rate in (0.0, 0.1):
            got, lse = K1.reprogramming_attention_fwd(qb, kb, vb, scale, rate,
                                                      drop_seed, with_lse=True)
            again = K1.reprogramming_attention_fwd(qb, kb, vb, scale, rate,
                                                   drop_seed, with_lse=True)
            lean = K1.reprogramming_attention_fwd(qb, kb, vb, scale, rate, drop_seed)
            want, want_lse = K1.plain_reprogramming_attention(
                qb.float(), kb.float(), vb.float(), scale, rate, drop_seed,
                with_lse=True)
            torch.cuda.synchronize()
            check(torch.equal(got, again[0]) and torch.equal(lse, again[1])
                  and torch.equal(got, lean),
                  f"K1 at B={B}, rate {rate}: two calls differ")
            e = max((got - want).abs().max().item(),
                    (lse - want_lse).abs().max().item())
            check(e <= K1_TOL, f"K1 disagrees with its plain version at B={B}, rate "
                               f"{rate}: {e} > {K1_TOL}")
            err = max(err, e)
            del want, want_lse
        res[B] = {"max_abs_err": err, "splits": splits,
                  "ms": cuda_ms(lambda: K1.reprogramming_attention(qb, kb, vb, scale)),
                  "drop_ms": cuda_ms(lambda: K1.reprogramming_attention_fwd(
                      qb, kb, vb, scale, 0.1, drop_seed, with_lse=True))}
        if B != K1_SHAPES[0][0]:
            continue
        # between the wrapper's entry and exit the card runs this file's kernel
        names = kernel_ms_by_name(
            lambda: K1.reprogramming_attention_fwd(qb, kb, vb, scale))
        check(names and all("reprog_attn" in n for n in names),
              f"K1's forward launched {sorted(names)}")
        res[B]["plain_ms"] = cuda_ms(lambda: K1.plain_reprogramming_attention(
            qb.float(), kb.float(), vb.float(), scale))
        # q k^T and p v, products of bf16 operands
        res[B].update(bound((qb, kb, vb), got, 2 * 2.0 * B * L * H * S * E, BF16_FLOPS))
    head, one = res[256], res[1]
    print(f"K1 reprogramming_attention (B, L, H, S) {list(K1_SHAPES)}, E={E}, rate 0 "
          f"and 0.1 with lse, the plain version's mask: max_abs_err "
          f"{max(r['max_abs_err'] for r in res.values()):.3e} (tol {K1_TOL:g}), bitwise "
          f"repeat. B=256: kernel {head['ms']:.3f} ms (rate 0.1 with lse "
          f"{head['drop_ms']:.3f}) vs plain {head['plain_ms']:.3f} ms (bound "
          f"{head['bound_ms']:.3f} ms by {head['bound_by']}); B=250 {res[250]['ms']:.3f} "
          f"ms; B=1 ({one['splits']} key splits and the combine kernel) "
          f"{one['ms']:.3f} ms (rate 0.1 with lse {one['drop_ms']:.3f})")
    return {**head, "max_abs_err": max(r["max_abs_err"] for r in res.values())}


# (T, B, I, H, D) of K2's forward: the head's two layers' shapes and the
# discriminator's two (the main path's), the head's first layer on the LLaMA
# backbone (I = 28 + 180 + 4096 + 16), then a ragged batch tile, one window
# of a clip (the cluster's one-row-tile instance), one direction, and the
# discriminator's at a ragged tile and B=1
K2_LLAMA = (34, 256, 4320, 350, 2)
# the head's first layer on TED Expressive (I = 127 + 840 + 768 + 16: the seed
# graph of 42 joints and its flag, the beat features, BERT, z): odd and over
# 1024, so the folded projection in 1-float pieces
K2_EXPR = (34, 256, 1751, 350, 2)
K2_MAIN = ((34, 256, 992, 350, 2), (34, 256, 700, 350, 2),
           (28, 256, 8, 64, 2), (28, 256, 128, 64, 2), K2_LLAMA, K2_EXPR)
K2_SHAPES = K2_MAIN + ((34, 250, 992, 350, 2), (34, 1, 992, 350, 2),
                       (34, 256, 700, 350, 1), (28, 250, 8, 64, 1),
                       (28, 1, 128, 64, 2),
                       # widths that are no multiple of 8 or of the cluster's
                       # blocks: one block (H = 100), a cluster (H = 203)
                       (7, 13, 20, 100, 2), (6, 43, 24, 203, 2))


def _k2_inputs(dev, seed, T, B, I, H, D):
    """x, W_ih, b_ih, W_hh, b_hh at torch's GRU scale, and a non-zero h0."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + 31 * T + B + I + H + D)
    s = H ** -0.5

    def arr(*shape, scale=s):
        return torch.randn(*shape, device=dev, generator=g) * scale
    return (arr(T, B, I, scale=1.0), arr(D, 3, I, H), arr(D, 3, 1, H),
            arr(D, 3, H, H), arr(D, 3, 1, H), arr(B, H, scale=0.5))


def phase_k2(dev, seed):
    import torch
    from hop_tpu_torch.ops import _build
    from hop_tpu_torch.ops import gru_fused as K2
    lib = _build.load()
    # the wrappers' copies of the kernels' choices: the recurrence kernel by H
    # alone, one rule for both directions; a forward cluster's rows by (B, D)
    for H in (10, 64, 65, 138, 139, 350, 352):
        variant = lib.hop_gru_recurrence_variant(H)
        check(variant in (0, 1) and ("block", "cluster")[variant]
              == K2.recurrence_variant(H),
              f"recurrence_variant({H}) is not the kernel's choice ({variant})")
    check(lib.hop_gru_recurrence_variant(K2.MAX_H + 1) < 0,
          f"the recurrence takes H={K2.MAX_H + 1}")
    for B, D in ((1, 1), (8, 2), (9, 1), (256, 1), (9, 2), (256, 2)):
        check(lib.hop_gru_fwd_cluster_rows(B, D) == K2.forward_cluster_rows(B, D),
              f"forward_cluster_rows({B}, {D}) is not the kernel's choice")
    # the wide layer's clusters: how many the card holds at once, against the
    # clusters of a bs-256 launch (one wave), forward and backward
    need = 2 * -(-256 // K2.CLUSTER_ROWS)
    for backward in (False, True):
        held = lib.hop_gru_active_clusters(350, int(backward))
        check(held >= need, f"the card holds {held} clusters of the H=350 recurrence "
                            f"(backward: {backward}); a bs-256 launch is {need}")
        check(lib.hop_gru_active_clusters(64, int(backward)) == 0,
              "the H=64 recurrence should run without clusters")
        print(f"GRU recurrence at H=350, {'backward' if backward else 'forward'}: "
              f"{K2.recurrence_variant(350)} of {K2.CLUSTER_BLOCKS} blocks x "
              f"{K2.CLUSTER_ROWS} rows (forward at one direction "
              f"{K2.forward_cluster_rows(256, 1)}), "
              f"{K2.recurrence_smem_bytes(350, backward)} B of shared memory a block; "
              f"active clusters {held}, a bs-256 launch has {need}; at H=64: "
              f"{K2.recurrence_variant(64)}, {K2.recurrence_smem_bytes(64, backward)} B")
    res = {}
    for shape in K2_SHAPES:
        T, B, I, H, D = shape
        args = _k2_inputs(dev, seed, *shape)
        got = K2.gru_fused_layer_fwd(*args, with_residuals=True)
        again = K2.gru_fused_layer_fwd(*args, with_residuals=True)
        lean = K2.gru_fused_layer(*args)
        want = K2.plain_gru_fused_layer(*args, with_residuals=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again))
              and torch.equal(lean, got[0]), f"K2 at {shape}: two calls differ")
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        check(err <= K2_TOL, f"K2 disagrees with its plain version at {shape}: "
                             f"{err} > {K2_TOL}")
        res[shape] = {"max_abs_err": err}
        if shape not in K2_MAIN and B != 1:
            continue
        r = res[shape]
        r["ms"] = cuda_ms(lambda: K2.gru_fused_layer(*args))
        r["res_ms"] = cuda_ms(lambda: K2.gru_fused_layer_fwd(*args, with_residuals=True))
        # the entry's two phases, each kernel's own time on the card
        names = kernel_ms_by_name(lambda: K2.gru_fused_layer_fwd(*args))
        r["proj_ms"] = ms_of(names, "gru_proj_kernel")
        r["rec_ms"] = ms_of(names, fwd_kernel_name(H))
        check(r["rec_ms"] > 0,
              f"K2's recurrence at {shape} is not the {K2.recurrence_variant(H)} kernel")
        check(r["proj_ms"] > 0 and r["rec_ms"] > 0
              and len(names) == 2, f"K2's forward at {shape} launched {sorted(names)}")
        if shape in K2_MAIN:
            r["plain_ms"] = cuda_ms(lambda: K2.plain_gru_fused_layer(*args), reps=5)
            # the projections of x and h onto 3 gates, each direction: counted
            # once in f32, though the projection runs three TF32 products
            r.update(bound(args, lean, 2.0 * T * B * D * 3 * H * (I + H), F32_FLOPS))
    print(f"K2 gru_fused_layer, {len(res)} shapes (T, B, I, H, D) {list(K2_SHAPES)}, "
          f"non-zero h0, lean and with residuals: max_abs_err "
          f"{max(r['max_abs_err'] for r in res.values()):.3e} (tol {K2_TOL:g}), "
          f"bitwise repeat")
    for shape, r in res.items():
        if "ms" in r:
            tail = (f" vs plain {r['plain_ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by "
                    f"{r['bound_by']})" if "plain_ms" in r else "")
            print(f"K2 at {shape}: lean {r['ms']:.3f} ms, with residuals "
                  f"{r['res_ms']:.3f} ms; projection kernel {r['proj_ms']:.3f} ms, "
                  f"recurrence kernel {r['rec_ms']:.3f} ms (W_hh resident in a "
                  f"{K2.recurrence_variant(shape[3])}){tail}")
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


def ted_route_config(gru_kernel: str = "fused", fused_step: bool = True,
                     audio_wire: str = "f32", attention: str = "plain"):
    """The TED config at its published widths on one GRU route and one
    attention route of the backbone."""
    import dataclasses
    from hop_tpu_torch.config import ted_config
    cfg = ted_config()
    return cfg.replace(
        hop=dataclasses.replace(cfg.hop, gru_kernel=gru_kernel, fused_step=fused_step),
        data=dataclasses.replace(cfg.data, audio_wire=audio_wire),
        llm=dataclasses.replace(cfg.llm, attention=attention))


def attention_launches(cfg, forwards: int, backwards: int = 0) -> dict:
    """Launches of the backbone's attention kernel: one per layer and trunk,
    of K4 on the "fused" route, K5 on the "block" route, none on "plain"."""
    kernel = {"plain": None, "fused": "K4", "block": "K5"}[cfg.llm.attention]
    if kernel is None:
        return {}
    return {kernel: cfg.llm.n_layers * forwards,
            kernel + "_bwd": cfg.llm.n_layers * backwards}


def forward_launches(cfg, n: int = 1) -> dict:
    """Kernel launches of n no-grad generator forwards: K1 once, per GRU
    layer K2 on the fused route or K3's lean forward on the stack route, and
    per backbone layer K4 or K5 on a kernel attention route."""
    layers = cfg.hop.gru_layers * n
    stack = cfg.hop.gru_kernel == "stack"
    return {**ZERO_COUNTS, "K1": n * cfg.hop.use_reprogramming,
            "K2": 0 if stack else layers,
            "K3_lean": layers if stack else 0, **attention_launches(cfg, n)}


def phase_serve(dev, seed, gru_kernel="fused", reference=None):
    """`reference`: the other route's output for the same weights and batch."""
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.models.hop import build_hop_model
    cfg = ted_route_config(gru_kernel)
    B = 256
    t0 = time.perf_counter()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed, device="cpu")
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
    launches = _launch_counts()
    check(tuple(out.shape) == (B, cfg.data.n_poses, cfg.data.pose_dim),
          f"forward shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "forward has non-finite values")
    check(launches == forward_launches(cfg),
          f"kernel launches in one {gru_kernel}-route forward: {launches}, "
          f"want {forward_launches(cfg)}")
    route = ""
    if reference is not None:
        gap = (out - reference).abs().max().item()
        check(gap <= ROUTE_TOL, f"{gru_kernel} route vs the other route's forward: "
                                f"{gap} > {ROUTE_TOL}")
        route = f"; vs the other route max_abs_diff {gap:.3e} (tol {ROUTE_TOL:g})"

    n = 8
    small = {k: v[:n].cpu() for k, v in batch.items()}
    with torch.inference_mode():
        ref = model_cpu(small["in_audio"], small["x_enc"], small["text"],
                        small["pre_seq"], small["vid_indices"], eps=small["eps"])[0]
    diff = (out[:n].cpu() - ref).abs().max().item()
    check(diff <= SERVE_TOL, f"card vs CPU forward differ by {diff} > {SERVE_TOL}")
    ms = cuda_ms(lambda: forward(batch), reps=10, warmup=2)
    print(f"serve [{gru_kernel} route]: TED HOPModel ({n_params / 1e6:.1f} M "
          f"params, set up in {setup_s:.1f} s) forward bs {B} -> "
          f"{tuple(out.shape)} finite; launches {_nonzero(launches)}; card vs CPU "
          f"(first {n}) max_abs_diff {diff:.3e} (tol {SERVE_TOL:g}){route}; "
          f"{ms:.2f} ms per forward")
    return model, launches, out


def phase_clips(model, dev, gru_kernel="fused", attention="plain", clip_seeds=(1, 2, 3)):
    import math
    from hop_tpu_torch.cli import test_checkpoint
    cfg = ted_route_config(gru_kernel, attention=attention)
    d = cfg.data
    seconds = 20.0
    unit, stride = d.n_poses / d.pose_resampling_fps, (
        d.n_poses - d.n_pre_poses) / d.pose_resampling_fps
    windows = math.ceil((seconds - unit) / stride) + 1
    frames = windows * d.n_poses - (windows - 1) * d.n_pre_poses
    times = []
    for clip_seed in clip_seeds:
        _reset_counts()
        t0 = time.perf_counter()
        out = test_checkpoint.main(["--device", str(dev), "--seed", str(clip_seed),
                                    "--clip-seconds", str(seconds),
                                    "--gru-kernel", gru_kernel,
                                    "--bert-attention", attention], model=model)
        times.append(time.perf_counter() - t0)
        check(out.shape == (frames, d.pose_dim), f"clip {clip_seed}: {out.shape}")
        check(_launch_counts() == forward_launches(cfg, windows),
              f"clip {clip_seed}: launches {_launch_counts()}")
    print(f"clips [{gru_kernel} route, {attention} attention]: {len(times)} x "
          f"{seconds:.0f} s synthetic clips at bs 1 -> {frames} frames each "
          f"({windows} windows, launches {_nonzero(_launch_counts())}); seconds per "
          f"clip {', '.join(f'{t:.3f}' for t in times)}")
    return _launch_counts()


def rel_err(got, want) -> tuple:
    """(max abs error, that error over the largest |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def _k1_bwd_inputs(dev, seed, B, L, H, E, S):
    """q, k, v, dO at bf16-exact values: the kernels read bf16, and the plain
    versions get the same values."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + B)
    q, do = (torch.randn(B, L, H, E, device=dev, generator=g) for _ in range(2))
    k, v = (torch.randn(H, S, E, device=dev, generator=g) for _ in range(2))
    return tuple(t.to(torch.bfloat16).float() for t in (q, k, v, do))


def phase_k1_bwd(dev, seed):
    import torch
    from hop_tpu_torch.ops import reprogramming_attention as K1
    E = K1.HEAD_DIM
    scale, drop_seed = E ** -0.5, 1234
    worst = {"out": 0.0, "abs": 0.0, "rel": 0.0}
    for B, L, H, S in K1_SHAPES:
        q, k, v, do = _k1_bwd_inputs(dev, seed + 1, B, L, H, E, S)
        for rate in (0.1, 0.0):
            args = (scale, rate, drop_seed)
            out, lse = K1.reprogramming_attention_fwd(q, k, v, *args, with_lse=True)
            want_out, want_lse = K1.plain_reprogramming_attention(q, k, v, *args,
                                                                  with_lse=True)
            got = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *args)
            again = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *args)
            want = K1.plain_reprogramming_attention_bwd(q, k, v, want_out, want_lse,
                                                        do, *args)
            torch.cuda.synchronize()
            tag = f"B={B}, rate {rate}"
            out_err = max((out - want_out).abs().max().item(),
                          (lse - want_lse).abs().max().item())
            check(out_err <= K1_TOL, f"K1 training forward at {tag}: {out_err} > {K1_TOL}")
            worst["out"] = max(worst["out"], out_err)
            for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(a, b), f"K1 bwd at {tag}: {name} differs between two "
                                         f"calls")
                e_abs, e_rel = rel_err(a, c)
                check(e_rel <= BWD_REL_TOL,
                      f"K1 bwd at {tag} {name}: {e_rel} > {BWD_REL_TOL} relative")
                worst["abs"], worst["rel"] = max(worst["abs"], e_abs), max(worst["rel"], e_rel)
            del want, want_out, want_lse
    B, L, H, S = K1_SHAPES[0]
    q, k, v, do = _k1_bwd_inputs(dev, seed + 1, B, L, H, E, S)
    args = (scale, 0.1, drop_seed)
    out, lse = K1.reprogramming_attention_fwd(q, k, v, *args, with_lse=True)

    # timed as the autograd Function calls it: q, k, v saved in bf16, dO in f32
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))

    def bwd():
        return K1.reprogramming_attention_bwd(qb, kb, vb, out, lse, do, *args)
    fwd_ms = cuda_ms(lambda: K1.reprogramming_attention_fwd(
        q, k, v, *args, with_lse=True), reps=10)
    fwd_plain_ms = cuda_ms(lambda: K1.plain_reprogramming_attention(
        q, k, v, *args, with_lse=True), reps=5)
    ms = cuda_ms(bwd, reps=10)
    rate0_ms = cuda_ms(lambda: K1.reprogramming_attention_bwd(
        qb, kb, vb, out, lse, do, scale, 0.0, drop_seed), reps=10)
    plain_ms = cuda_ms(lambda: K1.plain_reprogramming_attention_bwd(
        q, k, v, out, lse, do, *args), reps=5)
    names = kernel_ms_by_name(bwd)
    parts = {p: ms_of(names, "reprog_attn_bwd_" + p) for p in ("dq", "dkdv", "combine")}
    runs = K1.bwd_row_runs(B, L, H, S)
    check(all(t > 0 for t in parts.values()) and runs > 1,
          f"K1's backward launched {sorted(names)} in {runs} row runs")
    print(f"K1 bwd (B, L, H, S) {list(K1_SHAPES)}, E={E}, rate 0.1 and 0: training "
          f"forward out/lse max_abs_err {worst['out']:.3e} (tol {K1_TOL:g}); dq, dk, dv "
          f"max_abs_err {worst['abs']:.3e}, worst rel {worst['rel']:.2e} (tol "
          f"{BWD_REL_TOL:g} rel); bitwise repeat. B={B}, rate 0.1: forward kernel "
          f"{fwd_ms:.3f} ms vs plain {fwd_plain_ms:.3f} ms; backward kernel {ms:.3f} ms "
          f"(rate 0: {rate0_ms:.3f}) vs plain {plain_ms:.3f} ms; dq kernel "
          f"{parts['dq']:.3f} ms, dk/dv kernel in {runs} row runs {parts['dkdv']:.3f} "
          f"ms, run combine {parts['combine']:.3f} ms (torch.profiler)")
    # the function needs five products (s, dp, dq, dk, dv); the two kernels
    # recompute s and dp
    return {"max_abs_err": worst["abs"], "ms": ms, "plain_ms": plain_ms,
            "out_err": worst["out"],
            **bound((q, k, v, out, lse, do), bwd(), 5 * 2.0 * B * L * H * S * E,
                    BF16_FLOPS)}


def phase_k2_bwd(dev, seed):
    import torch
    from hop_tpu_torch.ops import _build
    from hop_tpu_torch.ops import gru_fused as K2
    lib = _build.load()
    res = {}
    for T, B, I, H in ((34, 256, 992, 350), (34, 256, 700, 350),
                       (28, 256, 8, 64), (28, 256, 128, 64), K2_LLAMA[:4], K2_EXPR[:4]):
        D = 2
        check(K2.bwd_workspace_floats(T, B, I, H, D)
              == lib.hop_gru_fused_bwd_workspace(T, B, I, H, D),
              f"bwd_workspace_floats at I={I}, H={H} is not the kernel's count")
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
        fwd_names = kernel_ms_by_name(
            lambda: K2.gru_fused_layer_fwd(*args, with_residuals=True))
        fwd_rec_ms = ms_of(fwd_names, fwd_kernel_name(H))
        check(fwd_rec_ms > 0, f"K2's forward at I={I}, H={H} launched {sorted(fwd_names)}")
        # dx is the GEMM's instance with rows along k, dW_ih and dW_hh the one
        # with k as the row index
        names = kernel_ms_by_name(lambda: K2.gru_fused_layer_bwd(*bwd_args))
        parts = {"recurrence": ms_of(names, "gru_bwd_resident_kernel"),
                 "dx": gemm_ms(names, True),
                 "dW_ih + dW_hh": gemm_ms(names, False),
                 "slice reduce": ms_of(names, "gru_splitk_reduce_kernel"),
                 "column sums": ms_of(names, "gru_colsum_kernel")}
        check(all(t > 0 for t in parts.values()),
              f"K2's backward at I={I} launched {sorted(names)}")
        worst = max(errs, key=lambda k: errs[k][1])
        print(f"K2 bwd (T={T}, B={B}, I={I}, H={H}, D={D}): forward with "
              f"residuals max_abs_err {fwd_err:.3e} (tol {K2_TOL:g}), "
              f"{fwd_ms:.3f} ms (its recurrence kernel {fwd_rec_ms:.3f} ms, "
              f"{fwd_kernel_name(H)}); backward worst {worst} rel "
              f"{errs[worst][1]:.2e} (tol {BWD_REL_TOL:g}), max_abs_err "
              f"{max(e[0] for e in errs.values()):.3e}; bitwise repeat; "
              f"backward kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms; "
              + ", ".join(f"{k} {t:.3f}" for k, t in parts.items())
              + " ms (torch.profiler)")
        # the dh carry (3H x H), dx and dW_ih (3H x I each), dW_hh (3H x H)
        res[(I, H)] = {"max_abs_err": max(e[0] for e in errs.values()), "ms": ms,
                       "plain_ms": plain_ms, "fwd_err": fwd_err, "fwd_rec_ms": fwd_rec_ms,
                       **bound(bwd_args, got,
                               2.0 * T * B * D * 3 * H * (2 * H + 2 * I), F32_FLOPS)}
    return res


ZERO_COUNTS = {"K1": 0, "K1_bwd": 0, "K2": 0, "K2_bwd": 0, "K3": 0,
               "K3_lean": 0, "K3_bwd": 0, "K6": 0, "K4": 0, "K4_bwd": 0,
               "K5": 0, "K5_bwd": 0}


def _launch_counts():
    from hop_tpu_torch.ops import attention as K4
    from hop_tpu_torch.ops import block_attention as K5
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import gru_seq as K6
    from hop_tpu_torch.ops import gru_stack as K3
    from hop_tpu_torch.ops import reprogramming_attention as K1
    return {"K1": K1.launches, "K1_bwd": K1.bwd_launches, "K2": K2.launches,
            "K2_bwd": K2.bwd_launches, "K3": K3.launches,
            "K3_lean": K3.lean_launches, "K3_bwd": K3.bwd_launches,
            "K6": K6.launches, "K4": K4.launches, "K4_bwd": K4.bwd_launches,
            "K5": K5.launches, "K5_bwd": K5.bwd_launches}


def _reset_counts():
    from hop_tpu_torch.ops import attention as K4
    from hop_tpu_torch.ops import block_attention as K5
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import gru_seq as K6
    from hop_tpu_torch.ops import gru_stack as K3
    from hop_tpu_torch.ops import reprogramming_attention as K1
    K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0
    K3.launches = K3.lean_launches = K3.bwd_launches = K6.launches = 0
    K4.launches = K4.bwd_launches = K5.launches = K5.bwd_launches = 0


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _trainable(module):
    return {k: p for k, p in module.named_parameters() if p.requires_grad}


def _busy_share(step, n: int, ms_per_step: float, host_ops: bool = True):
    """Kernel time on the card over n profiled steps, per step, over the
    unprofiled ms per step; and the eight kernels that took the most.
    `host_ops` false: the card's activity alone (no host-side spans such as
    the optimizer's among the top; far less profiler time on a step of many
    small ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    check(device_ms > 0, "torch.profiler recorded no kernel time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return device_ms / ms_per_step, device_ms, [
        (e.key[:60], e.self_device_time_total / 1e3 / n) for e in top]


def step_launches(cfg, disc_layers: int, use_gan: bool) -> dict:
    """Kernel launches of one train step, from its structure.

    Generator forwards: the fused step runs the trunk once (K1 forward 1)
    and the head twice, for the batch's speakers with residuals and for the
    shuffled ones lean; the 3-forward step runs whole forwards, one with a
    graph and one (shuffled speakers) without, and in its GAN variant a
    third (the D phase's sample) without: K1 forward 2 or 3. Only the
    forward with a graph is differentiated: K1 backward 1. Per GRU layer
    that gives `head` forwards with residuals and `head` backwards, and
    `head` lean forwards for each forward without a graph. The GAN variant
    adds the discriminator's three forwards (real, fake, G term), all with a
    graph: 3 * disc_layers forwards with residuals and as many backwards
    (the G term's backward carries the gradient to the generator). On the
    fused route both kinds of forward are K2 launches; on the stack route
    they are K3 and K3 lean. On a kernel attention route every trunk (as
    many as K1 forwards) runs K4 or K5 once per backbone layer, and the one
    trunk with a graph its backward once per layer. Without the
    reprogramming layer (`use_reprogramming=False`) no K1 runs."""
    head = cfg.hop.gru_layers
    no_graph = 1 if cfg.hop.fused_step else (2 if use_gan else 1)
    with_res = head + (3 * disc_layers if use_gan else 0)
    lean = head * no_graph
    trunks = 1 if cfg.hop.fused_step else 1 + no_graph
    k1 = int(cfg.hop.use_reprogramming)       # the ablation runs no K1
    want = {**ZERO_COUNTS, "K1": trunks * k1, "K1_bwd": k1,
            **attention_launches(cfg, trunks, 1)}
    if cfg.hop.gru_kernel == "stack":
        want.update(K3=with_res, K3_lean=lean, K3_bwd=with_res)
    else:
        want.update(K2=with_res + lean, K2_bwd=with_res)
    return want


def _first_gan_step(cfg, model, disc, state, gan, batch, noise_gen, before, name):
    """One GAN step, held to its launches as `step_launches` derives them,
    finite losses, every trainable parameter of both nets with a gradient
    moved (from `before`: the state_dicts, the discriminator's keys with
    "D."), the frozen backbone bit-unchanged. Returns (state, metrics,
    launches, the parameters without a gradient)."""
    import torch
    _reset_counts()
    state, metrics = gan(state, batch, noise_gen)
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = step_launches(cfg, disc.gru.num_layers, use_gan=True)
    check(launches == want, f"kernel launches in one GAN step ({name}): "
                            f"{launches}, want {want}")
    for k, v in metrics.items():
        check(bool(torch.isfinite(v)), f"train metric {k} = {v.item()}")
    # gwnet's last layer feeds only the residual path that its output does
    # not read (as in the reference): its GCN and BatchNorm get no gradient
    last = f"{len(model.gwnet.bn) - 1}."
    unused = {f"gwnet.{m}.{last}{w}" for m in ("gconv", "bn") for w in
              ("weight", "bias", "mlp.mlp.weight", "mlp.mlp.bias")}
    no_grad = []
    for net, module, prefix in (("generator", model, ""), ("discriminator", disc, "D.")):
        for k, p in _trainable(module).items():
            if p.grad is None:
                no_grad.append(prefix + k)
                continue
            check(not torch.equal(p.detach(), before[prefix + k]),
                  f"{net} parameter {k} did not move")
    check(set(no_grad) <= unused, f"parameters without a gradient: {no_grad}")
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(frozen and all(k.startswith("llm_model.") for k in frozen),
          f"frozen parameters: {frozen[:3]}...")
    for k in frozen:
        check(torch.equal(model.state_dict()[k], before[k]), f"frozen {k} changed")
    return state, metrics, launches, no_grad


def _step_times(gan, state, batch, noise_gen):
    """(ms per GAN step, CUDA-event median of 10; its kernels' ms and the
    busy share over 3 profiled steps; their top kernels; peak GiB)."""
    import torch

    def step():
        nonlocal state
        state, _ = gan(state, batch, noise_gen)
    ms = cuda_ms(step, reps=10, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    busy, device_ms, top = _busy_share(step, 3, ms)
    return ms, device_ms, busy, top, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train(dev, seed, gru_kernel="fused", fused_step=True, attention="plain"):
    """The GAN step at full TED width, bs 256, on one GRU route and one
    attention route: the fused step on a batch made on the card, or the
    3-forward step on host batches (numpy) brought over the int16 wire by
    `device_batch`, two warmup steps first."""
    import torch
    from hop_tpu_torch.cli.common import MODEL_BATCH_KEYS, device_batch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import make_host_batch, make_train_batch
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.train.llm import make_hop_train_steps
    cfg = ted_route_config(gru_kernel, fused_step,
                           "f32" if fused_step else "int16", attention)
    name = (f"{'fused' if fused_step else '3-forward'} GAN step, {gru_kernel} route, "
            f"{attention} attention")
    B = cfg.train.batch_size
    t0 = time.perf_counter()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed, device="cpu")
    disc_cpu = build_discriminator(cfg, seed + 1, device="cpu")
    model = copy.deepcopy(model_cpu).to(dev)
    disc = copy.deepcopy(disc_cpu).to(dev)
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    state = init_state()
    put_ms = None
    if fused_step:
        batch = make_train_batch(cfg, B, seed, N_SPEAKERS, dev)
    else:
        def host_to_card(batch_seed):
            nonlocal put_ms
            host = make_host_batch(cfg, B, batch_seed, N_SPEAKERS)
            t1 = time.perf_counter()
            out = device_batch(host, cfg, keys=MODEL_BATCH_KEYS["AD_LLM"], device=dev)
            torch.cuda.synchronize()
            put_ms = (time.perf_counter() - t1) * 1e3
            return out
        batch = host_to_card(seed)
        check(batch["in_audio"].dtype == torch.float32
              and batch["in_audio"].device.type == "cuda"
              and tuple(batch["log_mel"].shape) == (B, cfg.data.n_poses,
                                                    cfg.data.mel_bins),
              "device_batch: wrong fields")
    setup_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in
              list(model.state_dict().items()) + [("D." + k, v) for k, v in
                                                  disc.state_dict().items()]}
    noise_gen = torch.Generator().manual_seed(seed)
    d_layers = disc.gru.num_layers

    warm_launches = None
    if not fused_step:
        for i in range(2):
            _reset_counts()
            state, metrics = warmup(state, batch, noise_gen)
            torch.cuda.synchronize()
            warm_launches = _launch_counts()
            want = step_launches(cfg, d_layers, use_gan=False)
            check(warm_launches == want, f"kernel launches in one warmup step "
                                         f"({name}): {warm_launches}, want {want}")
            for k, v in metrics.items():
                check(bool(torch.isfinite(v)), f"warmup metric {k} = {v.item()}")
            batch = host_to_card(seed + 1 + i)
    state, metrics, launches, no_grad = _first_gan_step(
        cfg, model, disc, state, gan, batch, noise_gen, before, name)
    if not fused_step:
        for i in range(2):                      # GAN steps two and three
            batch = host_to_card(seed + 3 + i)
            state, metrics = gan(state, batch, noise_gen)
            for k, v in metrics.items():
                check(bool(torch.isfinite(v)), f"train metric {k} = {v.item()}")

    ms, device_ms, busy, top, peak_gb = _step_times(gan, state, batch, noise_gen)
    n_train = sum(p.numel() for p in _trainable(model).values())
    wire = "" if fused_step else (
        f"; host batches over the int16 wire, device_batch {put_ms:.2f} ms (host "
        f"clock); 2 warmup steps (launches {_nonzero(warm_launches)}) and 3 GAN steps")
    print(f"train [{name}]: TED full width, bs {B} (set up in "
          f"{setup_s:.1f} s; {n_train / 1e6:.1f} M trainable generator "
          f"params){wire}: losses finite ("
          + ", ".join(f"{k} {metrics[k].item():.4g}" for k in
                      ("loss", "KLD", "DIV_REG", "gen", "dis"))
          + f"); every trainable param of both nets with a gradient moved "
          f"({len(no_grad)} without one: gwnet's last GCN and BatchNorm), BERT "
          f"unchanged; "
          f"launches {_nonzero(launches)}; {ms:.2f} ms per step (CUDA-event median of "
          f"10); kernels {device_ms:.2f} ms per step, busy share {busy:.3f} "
          f"(torch.profiler, 3 steps); peak memory {peak_gb:.2f} GiB")
    print(f"train [{name}]: top kernels per step: " + "; ".join(
        f"{kname} {t:.2f} ms" for kname, t in top))
    return model_cpu, disc_cpu, launches


def phase_warmup_vs_cpu(model_cpu, disc_cpu, dev, seed, gru_kernel="fused",
                        fused_step=True, attention="plain"):
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import make_train_batch
    from hop_tpu_torch.train.llm import StepNoise, make_hop_train_steps
    cfg = ted_route_config(gru_kernel, fused_step, attention=attention)
    name = (f"{'fused' if fused_step else '3-forward'} step, {gru_kernel} route, "
            f"{attention} attention")
    B = 8
    batch = make_train_batch(cfg, B, seed + 2, N_SPEAKERS, device="cpu")
    noise = StepNoise.draw(torch.Generator().manual_seed(seed + 2), cfg, B)
    runs = []
    for device in (dev, torch.device("cpu")):
        model = copy.deepcopy(model_cpu).to(device)
        disc = copy.deepcopy(disc_cpu).to(device)
        check(model.gru.kernel == gru_kernel and disc.gru.kernel == gru_kernel
              and all(l.route == attention for l in model.llm_model.encoder.layer),
              "the nets were built for another route")
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
    print(f"warmup [{name}]: epoch-0 warmup step bs {B}, card vs CPU: losses rel "
          f"err {loss_err:.2e} (tol {TRAIN_LOSS_TOL:g}); gradients of "
          f"{len(errs)}/{len(g_cpu)} tensors (the rest are round-off of exact "
          f"zeros), worst rel err " + ", ".join(
              f"{k} {errs[k]:.2e}" for k in worst) + f" (tol {TRAIN_GRAD_TOL:g})")


def _k3_inputs(dev, seed, D, T, B, H, dtype):
    """Gate streams as the stack route hands them over, strided views of one
    (T, B, D, 3, H) product; weights at torch's GRU scale; a non-zero h0."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + 31 * T + H + B + D)
    s = H ** -0.5

    def arr(*shape, scale=s):
        return torch.randn(*shape, device=dev, generator=g) * scale
    proj = arr(T, B, D, 3, H, scale=1.0).to(dtype)
    streams = tuple(x.permute(2, 0, 1, 3) for x in proj.unbind(dim=3))
    return (*streams, arr(D, 3, H, H), arr(D, 3, 1, H), arr(B, H, scale=0.5)), \
        arr(D, T, B, H, scale=1.0)


# (D, T, B, H): the head, the discriminator, a ragged last tile, one
# direction, one window of a clip (the cluster's one-row-tile instance), the
# discriminator's at one direction and a ragged tile, and widths that are no
# multiple of 8 or of the cluster's blocks (H = 100: the forward in one block,
# the backward in a cluster; H = 203: both in a cluster)
K3_HEAD = (2, 34, 256, 350)
K3_DISC = (2, 28, 256, 64)
K3_ONE = (2, 34, 1, 350)
K3_SHAPES = (K3_HEAD, K3_DISC, (2, 34, 250, 350), (1, 34, 256, 350), K3_ONE,
             (1, 28, 250, 64), (2, 7, 13, 100), (2, 6, 43, 203))


def phase_k3_fwd(dev, seed):
    import torch
    from hop_tpu_torch.ops import gru_stack as K3
    from hop_tpu_torch.ops.gru_fused import recurrence_variant
    res = {}
    for shape in K3_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args, _ = _k3_inputs(dev, seed, *shape, dtype)
            full = K3.gru_stack_fwd(*args, with_residuals=True)
            again = K3.gru_stack_fwd(*args, with_residuals=True)
            lean = K3.gru_stack_fwd(*args)
            want = K3.plain_gru_stack(*args, with_residuals=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(full, again))
                  and torch.equal(lean, full[0]),
                  f"K3 forward at {shape} {dtype}: two calls differ")
            err = max((a - b).abs().max().item() for a, b in zip(full, want))
            lean_err = (lean - want[0]).abs().max().item()
            tag = f"{shape} {str(dtype).split('.')[-1]}"
            check(err <= K3_TOL, f"K3 forward with residuals at {tag}: {err} > {K3_TOL}")
            check(lean_err <= K3_TOL, f"K3 lean forward at {tag}: {lean_err} > {K3_TOL}")
            res[(shape, dtype)] = {"err": err, "lean_err": lean_err}
    D, T, B, H = K3_HEAD
    flops = 2.0 * T * B * D * 3 * H * H                  # h W[g], three gates
    for dtype in (torch.float32, torch.bfloat16):
        args, _ = _k3_inputs(dev, seed, *K3_HEAD, dtype)
        r = res[(K3_HEAD, dtype)]
        r["ms"] = cuda_ms(lambda: K3.gru_stack_fwd(*args, with_residuals=True))
        r["lean_ms"] = cuda_ms(lambda: K3.gru_stack_fwd(*args))
        r["plain_ms"] = cuda_ms(lambda: K3.plain_gru_stack(*args, with_residuals=True),
                                reps=10)
        r["lean_plain_ms"] = cuda_ms(lambda: K3.plain_gru_stack(*args), reps=10)
        full = K3.gru_stack_fwd(*args, with_residuals=True)
        r["bound"] = bound(args, full, flops, F32_FLOPS)
        r["lean_bound"] = bound(args, full[0], flops, F32_FLOPS)
    # the recurrence kernel's own time at the discriminator's shape (the
    # one-block kernel) and at one window of a clip
    own, own_bound = {}, {}
    for shape in (K3_HEAD, K3_DISC, K3_ONE):
        args, _ = _k3_inputs(dev, seed, *shape, torch.float32)
        shape_flops = 2.0 * shape[1] * shape[2] * shape[0] * 3 * shape[3] ** 2
        for label, with_res in (("residuals", True), ("lean", False)):
            own_bound[(shape, label)] = bound(
                args, K3.gru_stack_fwd(*args, with_residuals=with_res), shape_flops,
                F32_FLOPS)
            names = kernel_ms_by_name(
                lambda: K3.gru_stack_fwd(*args, with_residuals=with_res))
            variant = recurrence_variant(shape[3])
            kernel = fwd_kernel_name(shape[3])
            check(len(names) == 1 and ms_of(names, kernel) > 0,
                  f"K3's forward at {shape} ({variant}) launched {sorted(names)}")
            own[(shape, label)] = ms_of(names, kernel)
    print("K3 fwd, the recurrence kernel's own ms (torch.profiler), with residuals / "
          "lean, beside the bound: " + "; ".join(
              f"{shape} ({recurrence_variant(shape[3])}) "
              f"{own[(shape, 'residuals')]:.4f} / {own[(shape, 'lean')]:.4f} (bound "
              + " / ".join(f"{own_bound[(shape, x)]['bound_ms']:.4f} by "
                           f"{own_bound[(shape, x)]['bound_by']}"
                           for x in ("residuals", "lean")) + ")"
              for shape in (K3_HEAD, K3_DISC, K3_ONE)))
    f32, b16 = res[(K3_HEAD, torch.float32)], res[(K3_HEAD, torch.bfloat16)]
    worst = max(max(r["err"], r["lean_err"]) for r in res.values())
    print(f"K3 fwd gru_stack: {len(res)} cases (D, T, B, H) x (f32, bf16 streams) "
          f"{[s for s in K3_SHAPES]}, non-zero h0, strided streams: max_abs_err "
          f"{worst:.3e} (tol {K3_TOL:g}), residuals and lean, bitwise repeat. At {K3_HEAD}: with "
          f"residuals {f32['ms']:.3f} ms f32 / {b16['ms']:.3f} ms bf16 streams vs "
          f"plain {f32['plain_ms']:.3f} ms (bound {f32['bound']['bound_ms']:.3f} ms "
          f"by {f32['bound']['bound_by']}); lean {f32['lean_ms']:.3f} ms f32 / "
          f"{b16['lean_ms']:.3f} ms bf16 vs plain {f32['lean_plain_ms']:.3f} ms "
          f"(bound {f32['lean_bound']['bound_ms']:.3f} ms)")
    return {"max_abs_err": max(r["err"] for r in res.values()),
            "lean_max_abs_err": max(r["lean_err"] for r in res.values()),
            "head": f32, "head_bf16": b16,
            "disc_kernel_ms": own[(K3_DISC, "residuals")],
            "disc_lean_kernel_ms": own[(K3_DISC, "lean")],
            "disc_bound_ms": own_bound[(K3_DISC, "residuals")]["bound_ms"],
            "disc_lean_bound_ms": own_bound[(K3_DISC, "lean")]["bound_ms"]}


def phase_k3_bwd(dev, seed):
    import torch
    from hop_tpu_torch.ops import gru_stack as K3
    from hop_tpu_torch.ops.gru_fused import hprev_of, recurrence_variant
    names = ("dxr", "dxz", "dxn", "dw", "db", "dh0")
    res = {}
    for shape in K3_SHAPES:
        D, T, B, H = shape
        for dtype in (torch.float32, torch.bfloat16):
            args, g = _k3_inputs(dev, seed + 1, *shape, dtype)
            h_seq, r, z, n, hnb = K3.gru_stack_fwd(*args, with_residuals=True)
            bwd_args = (g, r, z, n, hnb, hprev_of(h_seq, args[5]), args[3], dtype)
            got = K3.gru_stack_bwd(*bwd_args)
            again = K3.gru_stack_bwd(*bwd_args)
            want = K3.plain_gru_stack_bwd(*bwd_args)
            torch.cuda.synchronize()
            tag = f"{shape} {str(dtype).split('.')[-1]}"
            errs = {}
            for name, a, b, c in zip(names, got, again, want):
                check(torch.equal(a, b), f"K3 bwd at {tag}: {name} differs between "
                                         f"two calls")
                check(a.dtype == c.dtype and a.shape == c.shape,
                      f"K3 bwd at {tag}: {name} is {a.dtype} {tuple(a.shape)}")
                errs[name] = rel_err(a.float(), c.float())
                tol = (K3_BF16_DX_TOL if dtype == torch.bfloat16
                       and name.startswith("dx") else BWD_REL_TOL)
                check(errs[name][1] <= tol,
                      f"K3 bwd at {tag} {name}: {errs[name][1]} > {tol} relative")
            check(got[0].dtype == dtype and got[5].shape == (D, B, H),
                  f"K3 bwd at {tag}: dx dtype or dh0 shape")
            if shape not in (K3_HEAD, K3_DISC):     # correctness and repeat only
                worst = max(errs, key=lambda k: errs[k][1])
                print(f"K3 bwd gru_stack_bwd {tag} "
                      f"({recurrence_variant(H)}): worst {worst} rel "
                      f"{errs[worst][1]:.2e}; bitwise repeat")
                res[(shape, dtype)] = {"max_abs_err": max(e[0] for e in errs.values())}
                continue
            ms = cuda_ms(lambda: K3.gru_stack_bwd(*bwd_args), reps=10)
            plain_ms = cuda_ms(lambda: K3.plain_gru_stack_bwd(*bwd_args), reps=5)
            fwd_names = kernel_ms_by_name(
                lambda: K3.gru_stack_fwd(*args, with_residuals=True))
            fwd_rec_ms = ms_of(fwd_names, fwd_kernel_name(H))
            check(fwd_rec_ms > 0, f"K3's forward at {tag} launched {sorted(fwd_names)}")
            kernels = kernel_ms_by_name(lambda: K3.gru_stack_bwd(*bwd_args))
            rec_ms = ms_of(kernels, "gru_bwd_resident_kernel")
            dw_ms = gemm_ms(kernels, False)
            check(rec_ms > 0 and dw_ms > 0, f"K3's backward launched {sorted(kernels)}")
            # the dh carry through W^T and dW = hprev^T d_hid, 3H x H each
            res[(shape, dtype)] = {
                "errs": errs, "ms": ms, "plain_ms": plain_ms,
                "max_abs_err": max(e[0] for e in errs.values()),
                **bound(bwd_args[:7], got, 2 * 2.0 * T * B * D * 3 * H * H, F32_FLOPS)}
            worst = max(errs, key=lambda k: errs[k][1])
            print(f"K3 bwd gru_stack_bwd {tag}: worst {worst} rel "
                  f"{errs[worst][1]:.2e}, max_abs_err "
                  f"{res[(shape, dtype)]['max_abs_err']:.3e} (tol {BWD_REL_TOL:g} rel; "
                  f"bf16 dx {K3_BF16_DX_TOL:g}); bitwise repeat; the forward's "
                  f"recurrence {fwd_rec_ms:.3f} ms ({fwd_kernel_name(H)}); "
                  f"kernel {ms:.3f} ms "
                  f"(recurrence {rec_ms:.3f}, dW_hh product {dw_ms:.3f}) "
                  f"vs plain {plain_ms:.3f} ms (bound "
                  f"{res[(shape, dtype)]['bound_ms']:.3f} ms by "
                  f"{res[(shape, dtype)]['bound_by']})")
    head = res[(K3_HEAD, torch.float32)]
    return {"max_abs_err": max(r["max_abs_err"] for r in res.values()), "head": head}


def phase_k6(gru, dev, seed):
    """`gru`: the full-width head's GRU on the card (fused route)."""
    import torch
    from hop_tpu_torch.ops import gru_seq as K6
    T, H = 34, gru.hidden_size
    res = {}
    # the head's layer at bs 256 and bs 1, and a narrow layer (the one-block
    # kernel), one direction each call
    for B, HK in ((256, H), (1, H), (256, 64)):
        g = torch.Generator(device=dev).manual_seed(seed + B + HK)
        s = HK ** -0.5
        args = (torch.randn(B, T, 3 * HK, device=dev, generator=g),
                torch.randn(3 * HK, HK, device=dev, generator=g) * s,
                torch.randn(3 * HK, device=dev, generator=g) * s,
                torch.randn(B, HK, device=dev, generator=g) * 0.5)
        err = 0.0
        for reverse in (False, True):
            before = K6.launches
            got = K6.gru_seq_layer(*args, reverse=reverse)
            again = K6.gru_seq_layer(*args, reverse=reverse)
            torch.cuda.synchronize()
            check(K6.launches == before + 2,
                  f"K6 at B={B}, H={HK}: {K6.launches - before} launches for 2 calls")
            check(torch.equal(got, again), f"K6 at B={B}, H={HK}: two calls differ")
            want = K6.plain_gru_seq_layer(*args, reverse=reverse)
            err = max(err, (got - want).abs().max().item())
        check(err <= K3_TOL, f"K6 disagrees with its plain version at B={B}, H={HK}: "
                             f"{err} > {K3_TOL}")
        names = kernel_ms_by_name(lambda: K6.gru_seq_layer(*args, reverse=True))
        kernel_ms = ms_of(names, fwd_kernel_name(HK))
        check(kernel_ms > 0, f"K6 at B={B}, H={HK} launched {sorted(names)}")
        res[(B, HK)] = {
            "max_abs_err": err, "kernel_ms": kernel_ms,
            "ms": cuda_ms(lambda: K6.gru_seq_layer(*args, reverse=True)),
            "plain_ms": cuda_ms(lambda: K6.plain_gru_seq_layer(*args), reps=10),
            **bound(args, got, 2.0 * T * B * 3 * HK * HK, F32_FLOPS)}
    # the whole head through K6 against the same parameters through K2
    check(gru.kernel == "fused", "phase_k6 wants the fused-route head")
    params = dict(gru.named_parameters())
    D = len(gru.suffixes)
    stack_ms = {}
    for B in (256, 1):
        g = torch.Generator(device=dev).manual_seed(seed + 7 + B)
        x = torch.randn(B, T, gru.weight_ih_l0.shape[1], device=dev, generator=g)

        def via_k6():
            return K6.gru_forward_seq(x, params, H, gru.num_layers, D == 2)

        def via_gru():
            with torch.no_grad():
                return gru(x)[0]
        _reset_counts()
        got = via_k6()
        torch.cuda.synchronize()
        launches = _launch_counts()
        check(launches == {**ZERO_COUNTS, "K6": D * gru.num_layers},
              f"gru_forward_seq launches {launches}")
        gap = (got - via_gru()).abs().max().item()
        check(gap <= ROUTE_TOL, f"gru_forward_seq vs the GRU through K2 at B={B}: "
                                f"{gap} > {ROUTE_TOL}")
        gru.kernel = "stack"
        k3_ms = cuda_ms(via_gru, reps=10)
        gru.kernel = "fused"
        stack_ms[B] = (gap, cuda_ms(via_k6, reps=10), cuda_ms(via_gru, reps=10), k3_ms)
    print(f"K6 gru_seq_layer (T={T}, one direction a call, both directions checked, "
          f"bitwise repeat, tol {K3_TOL:g}): "
          + "; ".join(f"B={B}, H={HK} ({fwd_kernel_name(HK)}) max_abs_err "
                      f"{r['max_abs_err']:.3e}, kernel {r['ms']:.3f} ms, own "
                      f"{r['kernel_ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms (bound "
                      f"{r['bound_ms']:.4f} ms by {r['bound_by']})"
                      for (B, HK), r in res.items())
          + f". gru_forward_seq on the head's {gru.num_layers} x BiGRU({H}) parameters "
          f"({D * gru.num_layers} launches) vs the GRU through K2: "
          + "; ".join(f"B={B} max_abs_diff {v[0]:.3e} (tol {ROUTE_TOL:g}), "
                      f"{v[1]:.3f} ms vs K2 route {v[2]:.3f} ms, K3 route {v[3]:.3f} ms"
                      for B, v in stack_ms.items()))
    head = res[(256, H)]
    return {**head, "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "b1_kernel_ms": res[(1, H)]["kernel_ms"],
            "h64_kernel_ms": res[(256, 64)]["kernel_ms"]}, launches


ATTN_SHAPE = (256, 34, 12, 64)      # (B, T, H, D) of the backbone at bs 256


def _attention_inputs(dev, seed, B):
    """q, k, v, dout (B, T, H, D) bf16, as the backbone's bf16 projections
    hand them over."""
    import torch
    _, T, H, D = ATTN_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed + B)
    return [torch.randn(B, T, H, D, device=dev, generator=g).to(torch.bfloat16)
            for _ in range(4)]


def phase_bert_attention(dev, seed):
    """K4 and K5, forward and backward, against their plain versions."""
    import torch
    from hop_tpu_torch.ops import attention as K4
    from hop_tpu_torch.ops import block_attention as K5
    _, T, H, D = ATTN_SHAPE
    scale, drop_seed = D ** -0.5, 4321
    mods = {"K4": (K4, K4.fused_attention_fwd, K4.fused_attention_bwd,
                   K4.plain_fused_attention, K4.plain_fused_attention_bwd,
                   K4_TOL, K4_BWD_REL_TOL),
            "K5": (K5, K5.block_attention_fwd, K5.block_attention_bwd,
                   K5.plain_block_attention, K5.plain_block_attention_bwd,
                   K5_TOL, BWD_REL_TOL)}
    res = {name: {"fwd_err": 0.0, "bwd_err": 0.0, "bwd_rel": 0.0} for name in mods}
    cross = 0.0
    for B in (ATTN_SHAPE[0], 1, 250):
        q, k, v, do = _attention_inputs(dev, seed, B)
        # the plain versions get the same bf16-rounded values, in f32
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        outs = {}
        for name, (_, fwd, bwd, plain, plain_bwd, tol, bwd_tol) in mods.items():
            r = res[name]
            for rate in (0.0, 0.1):
                args = (scale, rate, drop_seed)
                got, again = fwd(q, k, v, *args), fwd(q, k, v, *args)
                want = plain(qf, kf, vf, *args)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"{name} B={B}: not finite")
                check(torch.equal(got, again), f"{name} B={B} rate {rate}: forward "
                                               f"differs between two calls")
                err = (got.float() - want).abs().max().item()
                check(err <= tol, f"{name} forward at B={B}, rate {rate}: {err} > {tol}")
                r["fwd_err"] = max(r["fwd_err"], err)
                outs[(name, rate)] = got.float()
            for rate in (0.0, 0.1):
                args = (scale, rate, drop_seed)
                grads, again = bwd(q, k, v, do, *args), bwd(q, k, v, do, *args)
                want = plain_bwd(qf, kf, vf, dof, *args)
                torch.cuda.synchronize()
                for gname, a, b, c in zip(("dq", "dk", "dv"), grads, again, want):
                    check(torch.equal(a, b), f"{name} bwd at B={B}, rate {rate}: {gname} "
                                             f"differs between two calls")
                    e_abs, e_rel = rel_err(a.float(), c)
                    check(e_rel <= bwd_tol, f"{name} bwd at B={B}, rate {rate} {gname}: "
                                            f"{e_rel} > {bwd_tol} relative")
                    r["bwd_err"] = max(r["bwd_err"], e_abs)
                    r["bwd_rel"] = max(r["bwd_rel"], e_rel)
        for rate in (0.0, 0.1):     # one function, one mask
            gap = (outs[("K5", rate)] - outs[("K4", rate)]).abs().max().item()
            check(gap <= K4_TOL, f"K5 vs K4 at B={B}, rate {rate}: {gap} > {K4_TOL}")
            cross = max(cross, gap)
    # K5 in other groupings: the same result and the same mask
    q, k, v, do = _attention_inputs(dev, seed, ATTN_SHAPE[0])
    args = (scale, 0.1, drop_seed)
    want = K5.block_attention_fwd(q, k, v, *args)
    want_g = K5.block_attention_bwd(q, k, v, do, *args)
    grouping = 0.0
    for nb in (1, 2, 4):
        grouping = max(grouping, (K5.block_attention_fwd(q, k, v, *args, nb=nb)
                                  - want).abs().max().item())
        for a, c in zip(K5.block_attention_bwd(q, k, v, do, *args, nb=nb), want_g):
            check(rel_err(a, c)[1] <= BWD_REL_TOL, f"K5 bwd in groups of {nb}")
    check(grouping <= K5_TOL, f"K5 in groups of 1, 2, 4 vs 8: {grouping} > {K5_TOL}")

    B = ATTN_SHAPE[0]
    q1, k1, v1, do1 = _attention_inputs(dev, seed, 1)
    flops = 2 * 2.0 * B * H * T * T * D                   # q k^T and p v
    for name, (_, fwd, bwd, plain, plain_bwd, _, _) in mods.items():
        r = res[name]
        r["ms"] = cuda_ms(lambda: fwd(q, k, v, scale))
        r["drop_ms"] = cuda_ms(lambda: fwd(q, k, v, *args))
        r["plain_ms"] = cuda_ms(lambda: plain(q, k, v, scale), reps=10)
        r["bwd_ms"] = cuda_ms(lambda: bwd(q, k, v, do, *args))
        r["bwd_plain_ms"] = cuda_ms(lambda: plain_bwd(q, k, v, do, *args), reps=10)
        r["bound"] = bound((q, k, v), fwd(q, k, v, scale), flops, BF16_FLOPS)
        # five products: s, dp, dq, dk, dv
        r["bwd_bound"] = bound((q, k, v, do), bwd(q, k, v, do, *args), 2.5 * flops,
                               BF16_FLOPS)
        # own device time (the call launches its kernel and nothing else) and
        # the time over 50 calls a pair of events
        own = {}
        for key, fn in (("kernel_ms", lambda: fwd(q, k, v, scale)),
                        ("drop_kernel_ms", lambda: fwd(q, k, v, *args)),
                        ("b1_kernel_ms", lambda: fwd(q1, k1, v1, scale)),
                        ("bwd_kernel_ms", lambda: bwd(q, k, v, do, *args)),
                        # rate 0, like for like with SDPA's backward
                        ("bwd0_kernel_ms", lambda: bwd(q, k, v, do, scale)),
                        ("b1_bwd_kernel_ms", lambda: bwd(q1, k1, v1, do1, *args))):
            r[key], own[key] = own_ms(fn, f"{name} {key}")
            check(len(own[key]) <= 1 and all("attn_" in k for k in own[key]),
                  f"{name}: a call launched {own[key]}, not its kernel alone")
        r["loop_ms"] = loop_ms(lambda: fwd(q, k, v, scale))
        r["bwd_loop_ms"] = loop_ms(lambda: bwd(q, k, v, do, *args))
        print(f"{name} {fwd.__name__} / {bwd.__name__} (B={B}, T={T}, H={H}, D={D}; also "
              f"B=1 and B=250): forward max_abs_err {r['fwd_err']:.3e} (tol "
              f"{mods[name][5]:g}; rate 0 and 0.1, the plain version's mask), "
              f"backward worst rel {r['bwd_rel']:.2e} (tol {mods[name][6]:g}), "
              f"max_abs_err {r['bwd_err']:.3e}; rate 0 and 0.1; bitwise repeat; forward kernel "
              f"{r['ms']:.3f} ms (rate 0.1: {r['drop_ms']:.3f}) vs plain "
              f"{r['plain_ms']:.3f} ms (bound {r['bound']['bound_ms']:.3f} ms by "
              f"{r['bound']['bound_by']}); backward kernel {r['bwd_ms']:.3f} ms vs plain "
              f"{r['bwd_plain_ms']:.3f} ms (bound {r['bwd_bound']['bound_ms']:.3f} ms by "
              f"{r['bwd_bound']['bound_by']})")
        print(f"{name} own device time (torch.profiler): forward {fmt_ms(r['kernel_ms'])} "
              f"ms (rate 0.1: {fmt_ms(r['drop_kernel_ms'])}; B=1: "
              f"{fmt_ms(r['b1_kernel_ms'])}); backward {fmt_ms(r['bwd_kernel_ms'])} ms "
              f"(rate 0: {fmt_ms(r['bwd0_kernel_ms'])}; B=1: "
              f"{fmt_ms(r['b1_bwd_kernel_ms'])}); "
              f"50 calls a pair of events: forward {r['loop_ms']:.4f}, backward "
              f"{r['bwd_loop_ms']:.4f} ms a call; kernels "
              f"{[k[:48] for k in own['kernel_ms'] + own['bwd_kernel_ms']]}")
    print(f"K5 vs K4 on the same inputs and seed: max_abs_diff {cross:.3e} (tol "
          f"{K4_TOL:g}: K4's bf16 output); K5 in groups of 1, 2, 4 vs 8 samples: "
          f"max_abs_diff {grouping:.3e} (tol {K5_TOL:g})")
    return res


def phase_serve_attention(model, dev, seed):
    """`model`: the full-width stack-route model on the card. Its backbone's
    attention is switched to each kernel route and back on the same weights."""
    import torch
    B = 256
    batch = serving_batch(ted_route_config("stack"), B, seed, dev)

    def forward():
        with torch.inference_mode():
            return model(batch["in_audio"], batch["x_enc"], batch["text"],
                         batch["pre_seq"], batch["vid_indices"], eps=batch["eps"])[0]
    plain = forward()
    paths, ms, gaps = {}, {}, {}
    for route in ("fused", "block"):
        cfg = ted_route_config("stack", attention=route)
        model.llm_model.set_attention(route)
        _reset_counts()
        out = forward()
        torch.cuda.synchronize()
        paths[route] = _launch_counts()
        check(paths[route] == forward_launches(cfg),
              f"kernel launches in one forward, {route} attention: {paths[route]}, "
              f"want {forward_launches(cfg)}")
        check(bool(torch.isfinite(out).all()), f"{route} attention: non-finite forward")
        gaps[route] = (out - plain).abs().max().item()
        check(gaps[route] <= ATTN_ROUTE_TOL, f"{route} attention vs the plain route: "
                                             f"{gaps[route]} > {ATTN_ROUTE_TOL}")
    # plain, fused, block, block, fused, plain: each route's two medians
    for route in ("plain", "fused", "block", "block", "fused", "plain"):
        model.llm_model.set_attention(route)
        ms.setdefault(route, []).append(cuda_ms(forward, reps=10, warmup=2))
    print(f"serve [stack route, kernel attention]: forward bs {B} vs the plain "
          f"attention route on the same weights: "
          + "; ".join(f"{r} max_abs_diff {gaps[r]:.3e}, launches {_nonzero(paths[r])}"
                      for r in gaps)
          + f" (tol {ATTN_ROUTE_TOL:g}); ms per forward, two medians of 10 each: "
          + "; ".join(f"{r} {a:.2f}, {b:.2f}" for r, (a, b) in ms.items()))
    for route in ("fused", "block"):
        model.llm_model.set_attention(route)
        paths["clip_" + route] = phase_clips(model, dev, "stack", route, clip_seeds=(1,))
    model.llm_model.set_attention("plain")
    return paths


def gru_layer_yardstick(dev, seed, T, Bt, I, Hh, D=2):
    """One GRU layer (both directions, or one), T steps of Bt rows: cuDNN's
    torch.nn.GRU against the port's `ops.gru.GRU` on both routes with its
    weights (K2_TOL), and their ms, forward / forward + backward (CUDA-event
    medians), cuDNN's backward alone besides. The yardstick is timed here
    and used nowhere in the port."""
    import torch
    from hop_tpu_torch.ops.gru import GRU
    bi = D == 2
    torch.manual_seed(seed + I)
    ref = torch.nn.GRU(I, Hh, num_layers=1, bidirectional=bi).to(dev)
    ours = GRU(I, Hh, num_layers=1, bidirectional=bi).to(dev)
    ours.load_state_dict(ref.state_dict(), strict=True)
    x_tm = torch.randn(T, Bt, I, device=dev)
    x_bm = x_tm.transpose(0, 1).contiguous()
    gout = torch.randn(T, Bt, D * Hh, device=dev)
    with torch.no_grad():
        want = ref(x_tm)[0]
    row = {}
    for kernel in ("fused", "stack"):
        ours.kernel = kernel
        with torch.no_grad():
            gap = (ours(x_bm)[0].transpose(0, 1) - want).abs().max().item()
        check(gap <= K2_TOL, f"GRU layer on the {kernel} route vs cuDNN at T={T}, I={I}, "
                             f"H={Hh}, D={D}: {gap} > {K2_TOL}")

        def fwd():
            with torch.no_grad():
                return ours(x_bm)

        def fwd_bwd():
            xg = x_bm.clone().requires_grad_()
            out = ours(xg)[0]
            torch.autograd.grad(out, [xg, *ours.parameters()], gout.transpose(0, 1))
        row[kernel] = (cuda_ms(fwd, reps=10), cuda_ms(fwd_bwd, reps=10))

    def cudnn_fwd():
        with torch.no_grad():
            return ref(x_tm)

    def cudnn_graph():
        xg = x_tm.clone().requires_grad_()
        return xg, ref(xg)[0]

    def cudnn_bwd(made):
        xg, out = made
        torch.autograd.grad(out, [xg, *ref.parameters()], gout)
    row["cudnn"] = (cuda_ms(cudnn_fwd, reps=10),
                    cuda_ms(lambda: cudnn_bwd(cudnn_graph()), reps=10))
    row["cudnn_bwd"] = cuda_ms(cudnn_bwd, reps=10, setup=cudnn_graph)
    print(f"library: one {'Bi' if bi else ''}GRU layer (T={T}, B={Bt}, I={I}, H={Hh}), "
          f"forward / forward + backward ms: cuDNN torch.nn.GRU {row['cudnn'][0]:.3f} / "
          f"{row['cudnn'][1]:.3f} (backward alone {row['cudnn_bwd']:.3f}); fused route "
          f"(K2) {row['fused'][0]:.3f} / {row['fused'][1]:.3f}; stack route (matmul + "
          f"K3) {row['stack'][0]:.3f} / {row['stack'][1]:.3f}")
    return row


def phase_library(dev, seed):
    """Yardsticks: PyTorch calls that compute a kernel's function. They are
    timed here and used nowhere in the port."""
    import torch
    import torch.nn.functional as F
    from hop_tpu_torch.ops import reprogramming_attention as K1
    lib = {}
    # K1 at rate 0: every query row of every sample attends to the same S
    # prototypes, so the batch folds into the query axis
    B, L, H, E, S = 256, 34, 8, 128, 1500
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)
               for shape in ((B, L, H, E), (H, S, E), (H, S, E)))
    scale = E ** -0.5

    def sdpa():
        qf = q.permute(2, 0, 1, 3).reshape(1, H, B * L, E)
        out = F.scaled_dot_product_attention(qf, k[None], v[None], scale=scale)
        return out.reshape(H, B, L, E).permute(1, 2, 0, 3)
    gap = (sdpa().float() - K1.reprogramming_attention(q, k, v, scale)).abs().max().item()
    check(gap <= SDPA_TOL, f"SDPA does not compute K1's function: {gap} > {SDPA_TOL}")
    lib["K1"] = cuda_ms(sdpa)

    # its backward alone, on the same folded view: dk and dv come out summed
    # over the batch, as K1's are
    do = torch.randn(B, L, H, E, device=dev, generator=g).to(torch.bfloat16)

    def k1_graph():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        qf = leaves[0].permute(2, 0, 1, 3).reshape(1, H, B * L, E)
        out = F.scaled_dot_product_attention(qf, leaves[1][None], leaves[2][None],
                                             scale=scale)
        return leaves, out.reshape(H, B, L, E).permute(1, 2, 0, 3)

    def k1_sdpa_bwd(made):
        leaves, out = made
        return torch.autograd.grad(out, leaves, do)
    out, lse = K1.reprogramming_attention_fwd(q, k, v, scale, with_lse=True)
    ours = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, scale)
    bwd_gap = max(rel_err(a.float(), b)[1]
                  for a, b in zip(k1_sdpa_bwd(k1_graph()), ours))
    check(bwd_gap <= SDPA_BWD_REL_TOL, f"SDPA's backward does not compute K1's: "
                                       f"{bwd_gap} > {SDPA_BWD_REL_TOL} relative")
    lib["K1_bwd"] = cuda_ms(k1_sdpa_bwd, setup=k1_graph)
    print(f"library: F.scaled_dot_product_attention (bf16, rate 0) at K1's shape "
          f"{lib['K1']:.3f} ms, max_abs_diff to K1 {gap:.3e} (tol {SDPA_TOL:g}); its "
          f"backward alone {lib['K1_bwd']:.3f} ms, worst gradient rel diff to K1's "
          f"backward {bwd_gap:.2e} (tol {SDPA_BWD_REL_TOL:g})")

    # K4 / K5: per-(sample, head) attention is SDPA on (B, H, T, D) views
    from hop_tpu_torch.ops import block_attention as K5
    aq, ak, av, ado = _attention_inputs(dev, seed, ATTN_SHAPE[0])
    scale = ATTN_SHAPE[3] ** -0.5

    def bert_sdpa(q=aq, k=ak, v=av):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale).transpose(1, 2)
    gap = (bert_sdpa().float() - K5.block_attention_fwd(aq, ak, av, scale)).abs().max().item()
    check(gap <= SDPA_TOL, f"SDPA does not compute K4's and K5's function: {gap} > "
                           f"{SDPA_TOL}")

    def sdpa_graph():
        leaves = [t.clone().requires_grad_() for t in (aq, ak, av)]
        return leaves, bert_sdpa(*leaves)

    def sdpa_bwd(made):
        leaves, out = made
        torch.autograd.grad(out, leaves, ado)
    lib["attn_fwd"] = cuda_ms(bert_sdpa)
    lib["attn_bwd"] = cuda_ms(sdpa_bwd, setup=sdpa_graph)
    both = cuda_ms(lambda: sdpa_bwd(sdpa_graph()))
    # own device times: every kernel of the call; the backward's as the
    # kernels of forward + backward less those of the forward with its
    # leaves' copies
    lib["attn_fwd_kernel"], fwd_names = own_ms(bert_sdpa, "SDPA forward")
    graph_ms, _ = own_ms(sdpa_graph, "SDPA forward with its leaves' copies")
    both_ms, bwd_names = own_ms(lambda: sdpa_bwd(sdpa_graph()), "SDPA forward + backward")
    lib["attn_bwd_kernel"] = (None if None in (both_ms, graph_ms)
                              else both_ms - graph_ms)
    q1, k1, v1, _ = _attention_inputs(dev, seed, 1)
    lib["attn_fwd_b1_kernel"], _ = own_ms(lambda: bert_sdpa(q1, k1, v1), "SDPA at B=1")
    lib["attn_fwd_loop"] = loop_ms(bert_sdpa)
    lib["attn_bwd_loop"] = loop_ms(lambda: sdpa_bwd(sdpa_graph())) - loop_ms(sdpa_graph)
    print(f"library: F.scaled_dot_product_attention (bf16, rate 0) at K4's and K5's "
          f"shape {ATTN_SHAPE}: forward {lib['attn_fwd']:.3f} ms, backward alone "
          f"{lib['attn_bwd']:.3f} ms, forward + backward with its leaves' copies "
          f"{both:.3f} ms; max_abs_diff to K5 {gap:.3e} (tol {SDPA_TOL:g}); own device "
          f"time (torch.profiler): forward {fmt_ms(lib['attn_fwd_kernel'])} ms (B=1: "
          f"{fmt_ms(lib['attn_fwd_b1_kernel'])}; kernels {[n[:40] for n in fwd_names]}); "
          f"backward {fmt_ms(lib['attn_bwd_kernel'])} ms "
          f"(kernels of forward + backward {fmt_ms(both_ms)} less the forward's "
          f"{fmt_ms(graph_ms)}; "
          f"{len(bwd_names)} kernels); 50 calls a pair of events: forward "
          f"{lib['attn_fwd_loop']:.4f} ms, backward {lib['attn_bwd_loop']:.4f} ms a call")

    # one bidirectional GRU layer: cuDNN's, and the port's on both routes
    for T, Bt, I, Hh in ((34, 256, 992, 350), (34, 256, 700, 350),
                         (28, 256, 8, 64), (28, 256, 128, 64), K2_LLAMA[:4],
                         K2_EXPR[:4]):
        row = gru_layer_yardstick(dev, seed, T, Bt, I, Hh)
        lib[("gru_fwd", I, Hh)] = row["cudnn"][0]
        lib[("gru_bwd", I, Hh)] = row["cudnn_bwd"]
    return lib


# the validation pass: seeded 20 s source clips (26 windows each: >= 513,
# two batches of 256 and a ragged third) and the routes it runs on
EVAL_VIDEOS = 20
EVAL_BS = 256
EVAL_ROUTES = (("fused", "plain"), ("stack", "plain"), ("stack", "fused"),
               ("stack", "block"))
# Card against CPU, the same metric functions fed the card's generated
# poses, targets, audio and speaker ids: f32 reductions over 256 x 34 x 27
# elements and the feature net's convolutions in another order (TF32 off):
# 1e-4 relative. FGD from LAPACK's and cuSOLVER's eigh on 32 x 32
# covariances of >= 513 samples: 1e-3 relative. The onset masks and the
# motion-beat masks are thresholds of those values: held equal.
EVAL_REL_TOL = 1e-4
EVAL_FGD_REL_TOL = 1e-3


def phase_eval(dev, seed):
    """Returns {path name: launches} of the validation pass on each route."""
    import numpy as np
    import torch
    from hop_tpu_torch.cli import common as C
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.dataset import SpeechMotionDataset
    from hop_tpu_torch.data.preprocessor import DataPreprocessor
    from hop_tpu_torch.data.records import RecordReader
    from hop_tpu_torch.data.synthetic import make_source_clips
    from hop_tpu_torch.data.vocab import build_vocab
    from hop_tpu_torch.eval import beat, metrics
    from hop_tpu_torch.eval.evaluate import evaluate_testset
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.ops import mel, onset
    cfg = ted_route_config()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="hop_eval_")
    try:
        path = os.path.join(tmp, "val")
        t0 = time.perf_counter()
        videos = make_source_clips(cfg, n_videos=EVAL_VIDEOS, clip_seconds=20.0,
                                   seed=seed)
        clips_s = time.perf_counter() - t0
        n = DataPreprocessor(cfg.data, path).run(videos)
        pre_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path + ".bin") + os.path.getsize(path + ".idx")
        check(n >= 2 * EVAL_BS + 1, f"eval: {n} windows, want >= {2 * EVAL_BS + 1}")
        ds = SpeechMotionDataset(path, cfg.data)
        check(ds.reader.native, "eval: the record reader fell back to the numpy gather")
        ds.set_lang_model(build_vocab(
            "words", [[w for aux in ds._aux_cache for w in aux["words"]]],
            None, None, cfg.data.wordembed_dim))
        idx = np.random.default_rng(seed).permutation(n)[:EVAL_BS]
        got = ds.reader.gather(idx)
        want = RecordReader(path, ds.schema, use_native=False).gather(idx)
        check(all(np.array_equal(got[k], want[k]) for k in want),
              "eval: the native gather differs from the numpy gather")
        print(f"eval: {EVAL_VIDEOS} x 20 s clips -> {n} windows, record store "
              f"{nbytes / 2**20:.1f} MiB; native gather (bitwise the numpy gather "
              f"on {EVAL_BS} shuffled records); clips {clips_s:.2f} s, clips + "
              f"preprocess {pre_s:.2f} s (host clock) on {smi}")

        t0 = time.perf_counter()
        model = build_hop_model(cfg, N_SPEAKERS, seed, device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        ev_card = C.make_fgd_evaluator(cfg, ds.lang_model.n_words, None, dev)
        ev_cpu = C.make_fgd_evaluator(cfg, ds.lang_model.n_words, None, "cpu")
        setup_s = time.perf_counter() - t0
        n_seed = cfg.data.n_seed_frames
        epoch = cfg.loss.bc_start_epoch + 1
        paths = {}
        for gru, attn in EVAL_ROUTES:
            rcfg = ted_route_config(gru, attention=attn)
            model.gru.kernel = gru
            model.llm_model.set_attention(attn)
            record = []     # (device batch, speaker ids, generated poses)

            def gen(batch, vids, generator):
                with torch.inference_mode():
                    out = model(batch["in_audio"], batch["log_mel"],
                                batch["text_padded"], batch["target_vec"][:, :n_seed],
                                vids, generator=generator)[0]
                record.append((batch, vids, out))
                return out
            batches = (C.device_batch(b, rcfg, device=dev)
                       for b in ds.batches(EVAL_BS, shuffle=False, drop_last=False))
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            res = evaluate_testset(batches, gen, ev_card, epoch, rcfg, N_SPEAKERS,
                                   generator=torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()
            pass_s = time.perf_counter() - t0
            launches = _launch_counts()
            name = f"eval_{gru}_{attn}"
            paths[name] = launches
            n_batches = len(record)
            check(n_batches == -(-n // EVAL_BS) >= 3, f"{name}: {n_batches} batches")
            check(launches == forward_launches(rcfg, n_batches),
                  f"{name}: launches {launches}, want {forward_launches(rcfg, n_batches)}")
            fields = ("loss", "mae", "frechet_dist", "feat_dist", "bc", "diversity")
            check(all(np.isfinite(getattr(res, f)) for f in fields), f"{name}: {res}")
            check(res.diversity > 0, f"{name}: diversity {res.diversity}")
            check(not res.eval_net_trained, f"{name}: untrained net not marked")

            # the same functions on the CPU, fed the card's poses and inputs
            outs = iter([o.float().cpu() for _, _, o in record])
            ref = evaluate_testset(
                iter([{k: v.cpu() for k, v in b.items()} for b, _, _ in record]),
                lambda b, v, g: next(outs), ev_cpu, epoch, rcfg, N_SPEAKERS,
                speaker_ids=iter([v.cpu() for _, v, _ in record]))
            errs = {f: abs(getattr(res, f) - getattr(ref, f)) / max(abs(getattr(ref, f)), 1e-12)
                    for f in fields}
            for f, e in errs.items():
                tol = EVAL_FGD_REL_TOL if f == "frechet_dist" else EVAL_REL_TOL
                check(e <= tol, f"{name}: {f} card {getattr(res, f)} vs CPU "
                                f"{getattr(ref, f)}: {e:.3e} relative > {tol:g}")
            masks = [(onset.onset_detect_mask(b["in_audio"]).cpu(),
                      onset.onset_detect_mask(b["in_audio"].cpu())) for b, _, _ in record]
            check(all(torch.equal(a, c) for a, c in masks), f"{name}: onset masks differ")
            beats = [(beat.motion_beat_mask(beat.angle_diff_signal(o, cfg.data.skeleton)).cpu(),
                      beat.motion_beat_mask(beat.angle_diff_signal(o.cpu(), cfg.data.skeleton)))
                     for _, _, o in record]
            check(all(torch.equal(a, c) for a, c in beats), f"{name}: motion beats differ")
            print(f"eval [{gru} route, {attn} attention]: {n} windows in {n_batches} "
                  f"batches of {EVAL_BS} at epoch {epoch}: {res}; launches "
                  f"{_nonzero(launches)}; card vs CPU on the card's poses, relative: "
                  + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
                  + f" (tol {EVAL_REL_TOL:g}, FGD {EVAL_FGD_REL_TOL:g}); onset masks "
                  f"({sum(int(a.sum()) for a, _ in masks)} onsets) and motion beats "
                  f"equal; {pass_s:.3f} s per pass (host clock, batches made and "
                  f"moved inside) on {smi}")
            if (gru, attn) == EVAL_ROUTES[0]:
                first = record[0]
            del record

        # the pass's parts on the fused route, one batch of 256 each
        model.gru.kernel = "fused"
        model.llm_model.set_attention("plain")
        host, make = [], []
        for i in range(0, n, EVAL_BS):
            t0 = time.perf_counter()
            host.append(ds.make_batch(np.arange(i, min(n, i + EVAL_BS))))
            make.append((time.perf_counter() - t0) * 1e3)
        make_ms = statistics.median(make)
        put = []
        for h in host:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            C.device_batch(h, cfg, device=dev)
            torch.cuda.synchronize()
            put.append((time.perf_counter() - t0) * 1e3)
        batch, vids, out = first
        gen_gen = torch.Generator(device=dev).manual_seed(seed)

        def forward():
            with torch.inference_mode():
                return model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                             batch["target_vec"][:, :n_seed], vids, generator=gen_gen)[0]
        skel, target = cfg.data.skeleton, batch["target_vec"]

        def fk():
            return metrics.l1_loss(out, target), metrics.joint_mae(out, target, skel)

        def bc():
            return beat.beat_consistency(out, batch["in_audio"], skel)

        def features():
            ev_card.push_samples(out, target)
        forward_ms, fk_ms, bc_ms, feat_ms = (cuda_ms(f, reps=10, warmup=2)
                                             for f in (forward, fk, bc, features))
        ev_card.reset()
        audio = batch["in_audio"]
        mask = onset.onset_detect_mask(audio)
        n_fft, hop = 2048, 512
        window = torch.hann_window(n_fft, periodic=True, device=dev)

        def stft_power():
            spec = torch.stft(audio, n_fft, hop, window=window, center=True,
                              pad_mode="reflect", return_complex=True)
            return spec.real ** 2 + spec.imag ** 2
        onset_ms, power_ms, stft_ms = (cuda_ms(f, reps=10, warmup=2) for f in (
            lambda: onset.onset_detect_mask(audio),
            lambda: mel.power_spectrogram(audio, n_fft=n_fft, hop=hop), stft_power))
        ours = mel.power_spectrogram(audio, n_fft=n_fft, hop=hop)
        stft_err = float((stft_power().transpose(-1, -2) - ours).abs().max()
                         / ours.abs().max())
        # the onset detector's least time: a real FFT of each frame
        # (2.5 n log2 n operations), its power (3 a bin) and the mel
        # triangles' nonzeros (2 each), in f32 outside the tensor cores, or
        # its audio read once and its mask written once
        n_frames, n_bins = mask.shape[-1], n_fft // 2 + 1
        fb_nnz = int(np.count_nonzero(mel.mel_filterbank(
            16000, n_fft, 128, fmax=onset.ONSET_FMAX)))
        onset_flops = audio.shape[0] * n_frames * (
            2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * fb_nnz)
        onset_bound = bound([audio], [mask], onset_flops, F32_FLOPS)
        wait_ms = cuda_ms(lambda: onset._wait_suppress(mask, 1), reps=10, warmup=2)

        def one_pass():
            evaluate_testset(
                (C.device_batch(b, cfg, device=dev)
                 for b in ds.batches(EVAL_BS, shuffle=False, drop_last=False)),
                lambda b, v, g: forward_on(b, v), ev_card, epoch, cfg, N_SPEAKERS,
                generator=torch.Generator(device=dev).manual_seed(seed))

        def forward_on(b, v):
            with torch.inference_mode():
                return model(b["in_audio"], b["log_mel"], b["text_padded"],
                             b["target_vec"][:, :n_seed], v)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        busy, device_ms, top = _busy_share(one_pass, 1, warm_s * 1e3)
        # FGD + feature distance from the pass's own pushed features, warm
        check(ev_card.n_samples == n, f"eval: {ev_card.n_samples} features pushed, not {n}")
        scores = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev_card.get_scores()
            scores.append((time.perf_counter() - t0) * 1e3)
        scores_ms = statistics.median(scores)
        # where the metrics' device time goes: the onset detector's kernels and
        # copies, and those of FGD from the pass's 520 pushed features

        def top_of(fn):
            names = kernel_ms_by_name(fn, n=5)
            return "; ".join(f"{k[:48]} {t:.3f}" for k, t in
                             sorted(names.items(), key=lambda kv: -kv[1])[:4]) or "not recorded"
        onset_top = top_of(lambda: onset.onset_detect_mask(audio))
        scores_top = top_of(ev_card.get_scores)
        print(f"eval parts [fused route, plain attention], bs {EVAL_BS}: TED HOPModel "
              f"({n_params / 1e6:.1f} M params) and feature net set up in {setup_s:.1f} s; "
              f"make_batch {make_ms:.2f} ms (host clock, median of {len(host)}); "
              f"device_batch {statistics.median(put):.2f} ms (host clock to a "
              f"synchronize); forward {forward_ms:.2f} ms; metrics pass "
              f"{fk_ms + bc_ms + feat_ms:.2f} ms (L1 + FK MAE {fk_ms:.3f}, onsets + BC "
              f"{bc_ms:.2f}, feature net {feat_ms:.3f}; CUDA-event medians of 10); "
              f"FGD + feature distance from the pass's {n} features (eigh) {scores_ms:.2f} ms "
              f"(host clock, median of {len(scores)} warm calls); the onset detector alone "
              f"{onset_ms:.2f} ms (its matrix-product power spectrogram {power_ms:.2f}, "
              f"torch.stft's (cuFFT) {stft_ms:.3f} ms, max relative difference "
              f"{stft_err:.1e}; bound {onset_bound['bound_ms']:.4f} ms by "
              f"{onset_bound['bound_by']}, FFT operations); the onset wait loop at wait=1 "
              f"({n_frames} frames: a no-op at sr 16000, hop 512, where wait=0) "
              f"{wait_ms:.3f} ms; a warm pass {warm_s:.3f} s, its kernels "
              f"{device_ms:.2f} ms (torch.profiler), busy share {busy:.3f}; top "
              + ", ".join(f"{k} {t:.2f}" for k, t in top[:5])
              + f"; the onset detector's kernels, ms a call: {onset_top}; FGD's: "
              f"{scores_top}; on {smi}")
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the training run: `python -m hop_tpu_torch.cli.run_ted` at full TED width on
# 20 seeded 20 s synthetic clips (520 training windows: 2 steps of 256 an
# epoch, the last 8 dropped; the validation split is the first clip's 26
# windows, one batch), the GAN gate open from epoch 1
RUN_ARGS = ("--data", "synthetic", "--synthetic-videos", "20", "--warmup-epochs", "0",
            "--log-every", "1")
RUN_EPOCHS = 4
RUN_STOP = 2
RUN_PREFETCH = 2
RUN_TURNS = 1          # of (prefetch 0, 2, 2, 0) epochs for steps per second
DET_STEPS = 10         # GAN steps a timed block, in turns (held, free, free, held)
DET_TURNS = 1
DET_PROFILED = 2       # GAN steps a profiled block (torch.profiler's cost grows with them)


class _Tee:
    """Writes to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.text = stream, []

    def write(self, s):
        self.stream.write(s)
        self.text.append(s)

    def flush(self):
        self.stream.flush()


def _run_entry(entry, argv):
    """entry.main(argv) as `python -m` runs it: (its result, its output)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = entry.main(list(argv))
    return result, "".join(tee.text)


def _run_ted(argv):
    """run_ted.main(argv): ((state, best FGD), its output)."""
    from hop_tpu_torch.cli import run_ted
    return _run_entry(run_ted, argv)


def _epoch_seconds(out: str) -> list:
    import re
    return [float(x) for x in re.findall(r"Epoch: \d+ cost time: ([\d.]+)s", out)]


def _validation_seconds(out: str) -> list:
    import re
    return [float(x) for x in re.findall(r"Validation: ([\d.]+)s", out)]


def run_launches(cfg, epochs: int, steps: int, eval_batches: int, disc_layers: int) -> dict:
    """Kernel launches of a training run, from its structure: per epoch
    `steps` warmup steps (epochs up to cfg.loss.warmup_epochs) or GAN steps
    (after), then one validation pass of `eval_batches` no-grad forwards."""
    total = dict(ZERO_COUNTS)
    for epoch in range(epochs):
        use_gan = epoch > cfg.loss.warmup_epochs
        for counts, n in ((step_launches(cfg, disc_layers, use_gan), steps),
                          (forward_launches(cfg, eval_batches), 1)):
            for k, v in counts.items():
                total[k] += v * n
    return total


def _cudnn_determinism(state, gan, batches, rng, smi):
    """cuDNN held to its deterministic algorithms against free to pick them
    (`cudnn.benchmark` off in both, as the training entry point leaves it):
    one epoch of GAN steps run twice from the same state, the differing
    tensors counted, with TF32 off and as torch sets it (matmul off, cuDNN
    on); then the ms of a GAN step under each, in turns, on the host clock
    and as its kernels' device time. Leaves cuDNN held and TF32 off."""
    import torch
    from hop_tpu_torch.utils.checkpoint import differing_entries, flat_entries
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    step = gan.for_epoch(RUN_EPOCHS)
    snapshot = copy.deepcopy(state.state_dict())

    def restore():
        # a copy: torch's Adam.load_state_dict keeps the given moment
        # tensors and updates them in place
        state.load_state_dict(copy.deepcopy(snapshot))

    def epoch():
        restore()
        for i, batch in enumerate(batches):
            step(state, batch, rng(RUN_EPOCHS, i))
        return copy.deepcopy(state.state_dict())

    count = iter(range(10 ** 9))

    def one_step():
        i = next(count) % len(batches)
        step(state, batches[i], rng(RUN_EPOCHS, i))

    def steps_ms(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            one_step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    spans = [time.perf_counter()]
    try:
        repeats = {}
        for tf32 in ("off", "as torch sets it"):
            cudnn.allow_tf32 = tf32 != "off"
            for held in (True, False):
                cudnn.deterministic = held
                diff = differing_entries(epoch(), epoch())
                repeats[(tf32, held)] = len(diff)
        n_entries = len(flat_entries(snapshot))
        spans.append(time.perf_counter())
        cudnn.allow_tf32 = False
        ms, device_ms = {True: [], False: []}, {True: [], False: []}
        for held in (True, False):          # each setting's first steps, untimed
            cudnn.deterministic = held
            steps_ms(2)
        for held in (True, False, False, True) * DET_TURNS:
            cudnn.deterministic = held
            ms[held].append(steps_ms(DET_STEPS))
        spans.append(time.perf_counter())
        for held in (True, False, False, True):
            cudnn.deterministic = held
            device_ms[held].append(_busy_share(one_step, DET_PROFILED, 1.0)[1])
        spans.append(time.perf_counter())
    finally:
        cudnn.deterministic, cudnn.benchmark = True, False
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        restore()
    check(repeats[("off", True)] == 0 and repeats[("as torch sets it", True)] == 0,
          f"run: with cuDNN held deterministic an epoch did not repeat: {repeats}")
    med = {k: statistics.median(v) for k, v in ms.items()}
    dev = {k: statistics.median(v) for k, v in device_ms.items()}
    print(f"run, cuDNN deterministic (held) vs free to pick (benchmark off in both): one "
          f"epoch ({len(batches)} GAN steps) twice from the same state, checkpoint "
          f"entries that differ of {n_entries}: "
          + "; ".join(f"TF32 {tf32}, {'held' if held else 'free'} {n}"
                      for (tf32, held), n in repeats.items())
          + f"; ms a GAN step (the step alone, batches made beforehand, TF32 off, host "
          f"clock over {DET_STEPS} steps, {DET_TURNS} turns of held, free, free, held): held "
          + ", ".join(f"{t:.2f}" for t in ms[True]) + "; free "
          + ", ".join(f"{t:.2f}" for t in ms[False])
          + f"; median held {med[True]:.2f}, free {med[False]:.2f}, cost "
          f"{med[True] - med[False]:+.2f} ms a step; the step's kernels, ms a step "
          f"(torch.profiler over {DET_PROFILED} steps, held, free, free, held): held "
          + ", ".join(f"{t:.2f}" for t in device_ms[True]) + "; free "
          + ", ".join(f"{t:.2f}" for t in device_ms[False])
          + f"; cost {dev[True] - dev[False]:+.2f} ms; s (host clock) of the repeats, the "
          f"timed and the profiled steps " + ", ".join(
              f"{b - a:.1f}" for a, b in zip(spans, spans[1:])) + f"; on {smi}")


def _epoch_runner(args, state, n_speakers: int, seed: int, dev, start_epoch: int):
    """More epochs of a `run_ted` run (its parsed `args`) from `state`,
    through `run_training` on the run's own datasets, epoch `start_epoch`
    first. Returns (one_epoch(prefetch) -> (s of train steps, s of the
    validation pass), the GAN step, batches(epoch), the vocabulary)."""
    from hop_tpu_torch.cli import common as C
    from hop_tpu_torch.cli.train_main import generate_from_state
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.train.llm import make_hop_train_steps
    from hop_tpu_torch.train.loops import run_training
    from hop_tpu_torch.utils.prng import step_generator
    rcfg = C.apply_overrides(ted_config(), args)
    train_ds, val_ds, lang = C.load_datasets(rcfg, args)
    warmup, gan, _ = make_hop_train_steps(rcfg, state.model, state.disc)
    eval_fn = C.make_eval_fn(rcfg, val_ds, C.make_fgd_evaluator(rcfg, lang.n_words, None, dev),
                             functools.partial(generate_from_state, rcfg), n_speakers,
                             dev, prefetch=RUN_PREFETCH)

    def batches(epoch):
        for hb in train_ds.batches(rcfg.train.batch_size, shuffle=True, seed=seed + epoch):
            yield C.device_batch(hb, rcfg, keys=C.MODEL_BATCH_KEYS["AD_LLM"], device=dev)
    epoch_no = iter(range(start_epoch, 10 ** 6))

    def one_epoch(prefetch=RUN_PREFETCH):
        e = next(epoch_no)
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            run_training(rcfg, batches, warmup, gan, state,
                         rng=functools.partial(step_generator, seed), eval_fn=eval_fn,
                         epochs=e + 1, start_epoch=e, prefetch=prefetch)
        out = "".join(tee.text)
        return _epoch_seconds(out)[0], _validation_seconds(out)[0]
    return one_epoch, gan, batches, lang


def phase_run(dev, seed):
    """Returns the launches of run A, the uninterrupted run."""
    import functools
    import torch
    from hop_tpu_torch.cli import common as C
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.utils.checkpoint import CheckpointManager, differing_entries
    from hop_tpu_torch.utils.prng import step_generator
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="hop_run_")
    tempdir, tempfile.tempdir = tempfile.tempdir, tmp   # the runs' synthetic records
    try:
        def argv(name, epochs, prefetch, *extra):
            d = os.path.join(tmp, name)
            return (*RUN_ARGS, "--seed", str(seed), "--epochs", str(epochs),
                    "--prefetch", str(prefetch), "--checkpoint-dir", d,
                    "--metrics", os.path.join(d, "metrics.jsonl"), *extra)
        _reset_counts()
        t0 = time.perf_counter()
        (state_a, best_a), out_a = _run_ted(argv("A", RUN_EPOCHS, 0))
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        launches = _launch_counts()
        t0 = time.perf_counter()
        _, out_b1 = _run_ted(argv("B", RUN_STOP, RUN_PREFETCH, "--transfer-guard", "disallow"))
        (state_b, best_b), out_b2 = _run_ted(argv("B", RUN_EPOCHS, RUN_PREFETCH, "--resume",
                                                  "--transfer-guard", "disallow"))
        torch.cuda.synchronize()
        run_b_s = time.perf_counter() - t0
        check(f"resumed from checkpoint epoch {RUN_STOP - 1}" in out_b2,
              "run: B did not resume")

        # A and B end equal, bit for bit: the last checkpoints, the metric
        # streams, the best-FGD records
        a_dir, b_dir = os.path.join(tmp, "A"), os.path.join(tmp, "B")
        ck_a, ck_b = CheckpointManager(a_dir), CheckpointManager(b_dir)
        check(ck_a.latest_step() == ck_b.latest_step() == RUN_EPOCHS - 1,
              f"run: latest steps {ck_a.latest_step()}, {ck_b.latest_step()}")
        diff = differing_entries(ck_a.restore(), ck_b.restore())
        check(not diff, f"run: 4 epochs and 2 + resume to 4 differ at {diff[:6]}")
        files = {}
        for f in ("metrics.jsonl", "best_metrics.json"):
            a, b = (open(os.path.join(d, f)).read() for d in (a_dir, b_dir))
            check(a == b, f"run: {f} differs between A and B:\n{a}\n{b}")
            files[f] = a
        n_lines = len(files["metrics.jsonl"].splitlines())
        check(n_lines == 4 * RUN_EPOCHS, f"run: {n_lines} metric lines")
        check(best_a == best_b, f"run: best FGD {best_a} vs {best_b}")

        # the frozen backbone is the seed's init, untouched by training
        cfg = ted_config()
        meta = ck_a.run_metadata()
        n_speakers = int(meta["n_speakers"])
        fresh = build_hop_model(cfg, n_speakers, seed, "cpu").state_dict()
        for state in (state_a, state_b):
            got = state.model.state_dict()
            frozen = [k for k in fresh if k.startswith("llm_model.")]
            check(frozen and all(torch.equal(got[k].cpu(), fresh[k]) for k in frozen),
                  "run: the frozen backbone changed")
        del fresh, state_b

        # launches of run A, as derived from its steps and eval batches
        n_train = int(out_a.split("train samples: ")[1].split(",")[0])
        n_val = int(out_a.split("val: ")[1].split(",")[0])
        steps = n_train // cfg.train.batch_size
        eval_batches = -(-n_val // cfg.train.batch_size)
        want = run_launches(cfg.replace(loss=dataclasses.replace(cfg.loss, warmup_epochs=0)),
                            RUN_EPOCHS, steps, eval_batches, state_a.disc.gru.num_layers)
        check(launches == want, f"run: launches {launches}, want {want}")

        # the run's own epoch times: A at prefetch 0, B at prefetch 2 (its
        # first epoch after the resume pays a new model's first steps)
        times = {0: _epoch_seconds(out_a), RUN_PREFETCH: _epoch_seconds(out_b1)
                 + _epoch_seconds(out_b2)}
        check(all(len(t) == RUN_EPOCHS for t in times.values()), f"run: epochs {times}")

        # the checkpoint: size, save and restore
        ck = CheckpointManager(os.path.join(tmp, "io"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(0, state_a.state_dict())
        save_s = time.perf_counter() - t0
        size_gb = os.path.getsize(ck.path(0)) / 1e9
        t0 = time.perf_counter()
        state_a.load_state_dict(ck.restore())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0

        # more epochs of run A through run_training, the metrics fetched once
        # an epoch: prefetch 0 and 2 in turns (0, 2, 2, 0, ...) for steps per
        # second; then one epoch (its steps and its validation pass) timed
        # and profiled for the device's busy share
        t_more = time.perf_counter()
        args = C.base_parser("phase 22").parse_args(argv("C", RUN_EPOCHS, RUN_PREFETCH))
        one_epoch, gan, batches, _ = _epoch_runner(args, state_a, n_speakers, seed, dev,
                                                   RUN_EPOCHS)
        turns = {0: [], RUN_PREFETCH: []}
        val_s = []
        for p in (0, RUN_PREFETCH, RUN_PREFETCH, 0) * RUN_TURNS:
            train_s, v = one_epoch(p)
            turns[p].append(train_s)
            val_s.append(v)
        rate = {p: steps / statistics.median(t) for p, t in turns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_epoch()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        busy, device_ms, top = _busy_share(one_epoch, 1, epoch_s * 1e3)
        print(f"run [python -m hop_tpu_torch.cli.run_ted, TED full width, bs "
              f"{cfg.train.batch_size}, {n_train} training windows ({steps} steps an "
              f"epoch), {n_val} validation windows ({eval_batches} batch(es))]: A ({RUN_EPOCHS} "
              f"epochs, prefetch 0) and B ({RUN_STOP} epochs, prefetch {RUN_PREFETCH}, "
              f"then --resume to {RUN_EPOCHS}) end bit-identical (every tensor of the last "
              f"checkpoint: both nets, BatchNorm statistics, both Adam states, the step "
              f"count; metrics.jsonl, {n_lines} lines; best_metrics.json; best FGD "
              f"{best_a:.6g}); the frozen backbone is the seed's init; launches of A "
              f"{_nonzero(launches)} as derived; on {smi}")
        print(f"run times: A {run_a_s:.1f} s, B {run_b_s:.1f} s (host clock, model "
              f"builds and data included); s of train steps an epoch (--log-every 1: "
              f"the metrics fetched every step) A, prefetch 0: "
              + ", ".join(f"{t:.3f}" for t in times[0])
              + f"; B, prefetch {RUN_PREFETCH}, --transfer-guard disallow: "
              + ", ".join(f"{t:.3f}" for t in times[RUN_PREFETCH])
              + f"; then {len(val_s)} epochs more of A, prefetch 0 and {RUN_PREFETCH} in "
              f"turns, the metrics fetched once an epoch: s of train steps prefetch 0: "
              + ", ".join(f"{t:.3f}" for t in turns[0]) + f"; prefetch {RUN_PREFETCH}: "
              + ", ".join(f"{t:.3f}" for t in turns[RUN_PREFETCH])
              + f"; steps per second (median) prefetch 0 {rate[0]:.3f}, prefetch "
              f"{RUN_PREFETCH} {rate[RUN_PREFETCH]:.3f}; validation pass s (median of "
              f"{len(val_s)}) {statistics.median(val_s):.4f}, range {min(val_s):.4f}-"
              f"{max(val_s):.4f}; checkpoint {size_gb:.3f} GB, save {save_s:.2f} s, "
              f"restore {restore_s:.2f} s (host clock); one epoch more ({steps} steps + "
              f"validation, prefetch {RUN_PREFETCH}) {epoch_s:.3f} s, its kernels "
              f"{device_ms:.2f} ms (torch.profiler), busy share {busy:.3f}; top "
              + ", ".join(f"{k} {t:.2f}" for k, t in top[:5]) + f"; on {smi}")
        t_det = time.perf_counter()
        _cudnn_determinism(state_a, gan, list(batches(RUN_EPOCHS)),
                           functools.partial(step_generator, seed), smi)
        print(f"run: s (host clock) of A and B {run_a_s + run_b_s:.1f}, the epochs after "
              f"{t_det - t_more:.1f}, cuDNN held vs free {time.perf_counter() - t_det:.1f}")
        return launches
    finally:
        tempfile.tempdir = tempdir
        shutil.rmtree(tmp, ignore_errors=True)


# imported data: the 20 seeded 20 s clips of phases 21-22 as the reference's
# LMDBs (a source LMDB, one video a value; a cache LMDB, one window a value)
# imported into records; `run_ted` trains on them with a fastText .bin as
# the word vectors; `test_checkpoint --data` serves a clip of the source LMDB
IMPORT_EPOCHS = 2
IMPORT_CLIP = 3          # the clip test_checkpoint --data serves
FASTTEXT_BUCKET = 2000   # n-gram rows of the fabricated .bin


def write_fasttext_bin(path: str, words, dim: int, bucket: int, seed: int) -> None:
    """A fastText model in the .bin file format (v12: magic, version, args,
    dictionary, no prune map, dense input and output matrices; the layout
    of tests/test_fasttext_export.py), seeded input matrix."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((len(words) + bucket, dim)).astype(np.float32)
    out = bytearray(struct.pack("<ii", 793712314, 12))
    out += struct.pack("<12i", dim, 5, 5, 5, 5, 1, 1, 2, bucket, 3, 6, 100)
    out += struct.pack("<d", 1e-4)
    out += struct.pack("<iii", len(words), len(words), 0)
    out += struct.pack("<qq", 12345, -1)
    for w in words:
        out += w.encode("utf-8") + b"\0" + struct.pack("<qb", 7, 0)
    out += struct.pack("<b", 0) + struct.pack("<qq", *mat.shape) + mat.tobytes()
    out += struct.pack("<b", 0) + struct.pack("<qq", len(words), dim)
    out += bytes(4 * len(words) * dim)
    with open(path, "wb") as f:
        f.write(bytes(out))


def _same_files(a: str, b: str) -> bool:
    return all(open(a + ext, "rb").read() == open(b + ext, "rb").read()
               for ext in (".bin", ".idx"))


def phase_import(dev, seed):
    """Returns {path name: launches} of the training run on the imported
    records and of `test_checkpoint --data` on each GRU route."""
    import random
    import re
    import numpy as np
    import torch
    from hop_tpu_torch.cli import common as C
    from hop_tpu_torch.cli import test_checkpoint
    from hop_tpu_torch.config import ted_config
    from hop_tpu_torch.data import arrow_legacy, import_ted
    from hop_tpu_torch.data.fasttext_export import FastTextModel
    from hop_tpu_torch.data.lmdbfile import LmdbReader, write_lmdb
    from hop_tpu_torch.data.preprocessor import DataPreprocessor
    from hop_tpu_torch.data.records import RecordReader, schema_for
    from hop_tpu_torch.data.synthetic import make_source_clips
    from hop_tpu_torch.data.vocab import build_vocab
    from hop_tpu_torch.infer import generate_long_form, make_forward
    from hop_tpu_torch.utils.checkpoint import CheckpointManager
    cfg = ted_config()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="hop_import_")
    path = functools.partial(os.path.join, tmp)
    try:
        # 1. the source: the clips of phases 21-22, as the reference's LMDBs
        videos = make_source_clips(cfg, n_videos=EVAL_VIDEOS, clip_seconds=20.0, seed=seed)
        for name, vids in (("train", videos), ("val", videos[:1])):
            DataPreprocessor(cfg.data, path("direct_" + name)).run(vids)
        t0 = time.perf_counter()
        for name, vids in (("train", videos), ("val", videos[:1])):
            write_lmdb(path("lmdb_" + name), {
                b"%010d" % i: arrow_legacy.serialize({"vid": vid, "clips": [{
                    "skeletons_3d": c.skeletons_3d, "audio_raw": c.audio_raw,
                    "audio_feat": c.audio_spectrogram, "words": [list(w) for w in c.words],
                    "start_frame_no": c.start_frame_no, "end_frame_no": c.end_frame_no,
                    "start_time": c.start_time, "end_time": c.end_time} for c in clips]})
                for i, (vid, clips) in enumerate(vids)})
        write_s = time.perf_counter() - t0
        d, skel = cfg.data, cfg.data.skeleton
        schema = schema_for(d.n_poses, d.pose_resampling_fps, skel.n_joints, skel.n_bones,
                            d.mel_bins)
        direct = RecordReader(path("direct_train"), schema, use_native=False)
        items = {}
        for i in range(len(direct)):
            rec, aux = direct[i]
            items[b"%010d" % i] = arrow_legacy.serialize([
                [list(w) for w in aux["words"]], np.asarray(rec["pose_seq"]),
                np.asarray(rec["vec_seq"]).reshape(schema.n_frames_ext, -1),
                np.asarray(rec["audio"]), np.asarray(rec["spectrogram"]),
                {k: aux[k] for k in ("vid", "start_frame_no", "end_frame_no",
                                     "start_time", "end_time")}])
        write_lmdb(path("lmdb_cache"), items)
        del direct, items

        # 2. import: the decode rate, the imports (source, source with the
        # log-mel verified on the card, cache), --dry-import; each import
        # byte-equal to the records the preprocessor wrote from the clips
        rates = {}
        for name in ("train", "cache"):
            with LmdbReader(path("lmdb_" + name)) as reader:
                values = [v for _, v in reader.items()]
            t0 = time.perf_counter()
            for v in values:
                import_ted.load_value(v)
            rates[name] = (sum(map(len, values)) / 2 ** 20, time.perf_counter() - t0, len(values))
            del values

        def imported(name, *argv):
            tee = _Tee(sys.stdout)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                check(import_ted.main(list(argv)) == 0, f"import: {name} failed")
            return time.perf_counter() - t0, "".join(tee.text)
        import_s, _ = imported("source", "--src", path("lmdb_train"), "--out", path("imp_plain"))
        verify_s, out = imported("source --verify", "--src", path("lmdb_train"), "--out",
                                 path("imp_train"), "--verify", "--device", str(dev))
        mel_db = float(re.search(r"mel: \d+ clips, max\|Δ\| (\S+) dB", out).group(1))
        imported("val", "--src", path("lmdb_val"), "--out", path("imp_val"))
        cache_s, _ = imported("cache", "--src", path("lmdb_cache"), "--out", path("imp_cache"),
                              "--src-kind", "cache")
        dry_s, out = imported("dry-import", "--src", path("lmdb_train"), "--dry-import")
        check(f"dry-import ok: path={path('lmdb_train')} entries={EVAL_VIDEOS}" in out,
              f"import: --dry-import said {out!r}")
        for got, want in (("imp_plain", "direct_train"), ("imp_train", "direct_train"),
                          ("imp_val", "direct_val"), ("imp_cache", "direct_train")):
            check(_same_files(path(got), path(want)),
                  f"import: {got} differs from the preprocessor's records {want}")
        print(f"import [{EVAL_VIDEOS} x 20 s clips as a source LMDB ({rates['train'][0]:.1f} "
              f"MiB of values, written in {write_s:.2f} s) and a cache LMDB of "
              f"{rates['cache'][2]} windows ({rates['cache'][0]:.1f} MiB)]: records "
              f"byte-equal to the preprocessor's from the clips (source, source --verify, "
              f"val, cache); decode (arrow_legacy, no pyarrow) "
              + ", ".join(f"{k} {mib / t:.1f} MiB/s ({n} values in {t:.3f} s)"
                          for k, (mib, t, n) in rates.items())
              + f"; import s (host clock): source {import_s:.2f}, source --verify on the "
              f"card {verify_s:.2f} (verify {verify_s - import_s:+.2f}), cache {cache_s:.2f}, "
              f"--dry-import {dry_s:.2f}; the log-mel recomputed on the card (TF32 off) vs "
              f"the clips' stored spectrograms: max |Δ| {mel_db:.3e} dB (tol 0.25); on {smi}")

        # 3. train: run_ted on the imported records, a fastText .bin as the
        # word vectors; launches as derived from its steps and eval batches
        words = sorted({w[0] for _, clips in videos for c in clips for w in c.words})
        write_fasttext_bin(path("words.bin"), words + ["</s>"], cfg.data.wordembed_dim,
                           FASTTEXT_BUCKET, seed)
        run_dir = path("run")
        argv = ["--data", path("imp_train"), "--val-data", path("imp_val"),
                "--wordembed-path", path("words.bin"), "--warmup-epochs", "0",
                "--log-every", "1", "--seed", str(seed), "--epochs", str(IMPORT_EPOCHS),
                "--checkpoint-dir", run_dir, "--metrics", os.path.join(run_dir, "m.jsonl")]
        paths = {}
        _reset_counts()
        t0 = time.perf_counter()
        (state, best), out = _run_ted(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        paths["import_train_run"] = launches = _launch_counts()
        n_train = int(out.split("train samples: ")[1].split(",")[0])
        n_val = int(out.split("val: ")[1].split(",")[0])
        steps = n_train // cfg.train.batch_size
        eval_batches = -(-n_val // cfg.train.batch_size)
        want = run_launches(cfg.replace(loss=dataclasses.replace(cfg.loss, warmup_epochs=0)),
                            IMPORT_EPOCHS, steps, eval_batches, state.disc.gru.num_layers)
        check(launches == want, f"import run: launches {launches}, want {want}")
        lines = [json.loads(x) for x in open(os.path.join(run_dir, "m.jsonl"))]
        check(lines and all(math.isfinite(v) for x in lines for v in x.values()
                            if isinstance(v, float)), "import run: a metric is not finite")
        epoch_s = _epoch_seconds(out)
        check(len(epoch_s) == IMPORT_EPOCHS, f"import run: epochs {epoch_s}")
        n_speakers = int(CheckpointManager(run_dir).run_metadata()["n_speakers"])
        args = C.base_parser("phase 23").parse_args(argv)
        one_epoch, _, _, lang = _epoch_runner(args, state, n_speakers, seed, dev, IMPORT_EPOCHS)
        vectors = FastTextModel(path("words.bin"))
        check(all(np.array_equal(lang.word_embedding_weights[lang.word2index[w]],
                                 vectors.get_word_vector(w)) for w in words),
              "import run: the vocabulary's vectors are not the .bin's")
        one_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_epoch()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        busy, device_ms, top = _busy_share(one_epoch, 1, wall_s * 1e3)
        del state, one_epoch
        print(f"import run [python -m hop_tpu_torch.cli.run_ted --data <imported> "
              f"--val-data <imported> --wordembed-path <.bin>, TED full width, bs "
              f"{cfg.train.batch_size}, {n_train} training windows ({steps} steps an epoch), "
              f"{n_val} validation windows]: {IMPORT_EPOCHS} epochs in {run_s:.1f} s (model "
              f"builds and data included), s of train steps an epoch "
              + ", ".join(f"{t:.3f}" for t in epoch_s)
              + f"; finite metrics, best FGD {best:.6g}; the vocabulary's vectors those of "
              f"the .bin ({len(words)} words); launches {_nonzero(launches)} as derived; one "
              f"epoch more ({steps} steps + validation, prefetch {RUN_PREFETCH}) "
              f"{wall_s:.3f} s, its kernels {device_ms:.2f} ms (torch.profiler), busy share "
              f"{busy:.3f}; top " + ", ".join(f"{k} {t:.2f}" for k, t in top[:4])
              + f"; on {smi}")

        # 4. serve: test_checkpoint --data <source LMDB> from the run's
        # checkpoint on each GRU route, against generate_long_form called
        # directly with the same clip, seed pose, weights and generator
        for route in ("fused", "stack"):
            argv = ["--device", str(dev), "--data", path("lmdb_train"), "--clip-index",
                    str(IMPORT_CLIP), "--checkpoint-dir", run_dir, "--gru-kernel", route,
                    "--seed", str(seed)]
            _reset_counts()
            t0 = time.perf_counter()
            got = test_checkpoint.main(argv)
            torch.cuda.synchronize()
            clip_s = time.perf_counter() - t0
            paths[f"import_clip_{route}"] = launches = _launch_counts()
            rcfg, model, n_speakers = C.restore_hop_model(
                test_checkpoint.config_from_args(test_checkpoint.parse_args(argv)), run_dir,
                device=dev, seed=seed)
            clip, _ = test_checkpoint.read_source_clip(path("lmdb_train"), IMPORT_CLIP)
            want = generate_long_form(
                rcfg, make_forward(model), clip.audio_raw, clip.words,
                test_checkpoint.clip_seed_dir_vec(rcfg, clip),
                build_vocab("words", [clip.words], None, None, d.wordembed_dim),
                vid_index=random.Random(seed).randrange(n_speakers),
                generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
            del model
            seconds = len(clip.audio_raw) / d.sample_rate
            windows = math.ceil((seconds - d.n_poses / d.pose_resampling_fps)
                                / ((d.n_poses - d.n_pre_poses) / d.pose_resampling_fps)) + 1
            frames = windows * d.n_poses - (windows - 1) * d.n_pre_poses
            check(got.shape == (frames, d.pose_dim) and np.isfinite(got).all(),
                  f"import clip [{route}]: {got.shape}")
            check(np.array_equal(got, want),
                  f"import clip [{route}]: test_checkpoint --data differs from "
                  f"generate_long_form by {np.abs(got - want).max()}")
            check(launches == forward_launches(rcfg, windows),
                  f"import clip [{route}]: launches {launches}")
            print(f"import clip [{route} route]: test_checkpoint --data <source LMDB> "
                  f"--clip-index {IMPORT_CLIP} --checkpoint-dir <the run> -> {got.shape} "
                  f"finite, bitwise generate_long_form's on the same clip, seed pose, "
                  f"weights and generator; launches {_nonzero(launches)} ({windows} windows); "
                  f"{clip_s:.2f} s (host clock, the model's restore included) on {smi}")
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the LLaMA backbone (`--llm-model LLAMA`): the TED config with LLaMA-7B's
# geometry (dim 4096, 32 heads, MLP 11008, vocab 32000) at the reference's
# default depth of 6 layers; the run part at LLAMA_RUN_LAYERS, 4096 wide, to
# stay in time
LLAMA_LAYERS = 6
LLAMA_RUN_LAYERS = 2
LLAMA_RUN_EPOCHS = 2
LLAMA_CPU_SAMPLES = 2
LLAMA_CLIP_SECONDS = 20.0
# the fabricated checkpoint's first shard: the embeddings, the final norm
# and the layers below this one; the second shard the rest
LLAMA_SHARD_SPLIT = 3


def llama_route_config(gru_kernel: str = "fused", n_layers: int = LLAMA_LAYERS):
    from hop_tpu_torch.config import llama7b_llm_config
    return ted_route_config(gru_kernel).replace(llm=llama7b_llm_config(n_layers))


def backbone_flops(cfg, tokens: int) -> float:
    """Operations of the LLaMA backbone's forward over `tokens` tokens of
    T = n_poses: its seven projections a layer, and QK^T and PV."""
    llm, T = cfg.llm, cfg.data.n_poses
    kv = (llm.n_kv_heads or llm.n_heads) * (llm.dim // llm.n_heads)
    per_token = 2 * (2 * llm.dim * llm.dim + 2 * llm.dim * kv
                     + 3 * llm.dim * llm.intermediate_dim) + 2 * 2 * T * llm.dim
    return float(per_token * tokens * llm.n_layers)


def write_llama_checkpoint(directory: str, state_dict: dict, cfg) -> dict:
    """`state_dict` (the port's LlamaEncoder names, bf16 on the host) as HF
    publishes LLaMA-7B, under LlamaForCausalLM's `model.` prefix: in
    `directory`/st two safetensors shards (the first with the embeddings,
    the final norm and layers < LLAMA_SHARD_SPLIT), their
    `model.safetensors.index.json` and a `config.json`; in `directory`/bin
    one `pytorch_model.bin` of the same arrays. Returns the two paths and
    the seconds and bytes written."""
    import torch
    from hop_tpu_torch.utils import safetensors_io
    st, binary = os.path.join(directory, "st"), os.path.join(directory, "bin")
    config = json.dumps({"model_type": "llama", "hidden_size": cfg.dim,
                         "num_hidden_layers": cfg.n_layers, "vocab_size": cfg.vocab_size,
                         "intermediate_size": cfg.intermediate_dim,
                         "num_attention_heads": cfg.n_heads, "torch_dtype": "bfloat16"})

    def first(k):
        return not k.startswith("layers.") or int(k.split(".")[1]) < LLAMA_SHARD_SPLIT
    shards = {"model-00001-of-00002.safetensors": [k for k in state_dict if first(k)],
              "model-00002-of-00002.safetensors": [k for k in state_dict if not first(k)]}
    t0 = time.perf_counter()
    for d in (st, binary):
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            f.write(config)
    for name, keys in shards.items():
        safetensors_io.write({"model." + k: state_dict[k] for k in keys},
                             os.path.join(st, name))
    with open(os.path.join(st, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {"model." + k: name for name, keys
                                                  in shards.items() for k in keys}}, f)
    torch.save({"model." + k: v for k, v in state_dict.items()},
               os.path.join(binary, "pytorch_model.bin"))
    return {"st": st, "bin": binary, "seconds": time.perf_counter() - t0,
            "bytes": 2 * sum(v.numel() * v.element_size() for v in state_dict.values())}


def phase_llama(dev, seed):
    """Returns {path name: launches} of the LLaMA paths."""
    import numpy as np
    import torch
    from hop_tpu_torch.cli import test_checkpoint
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import make_clip, make_train_batch
    from hop_tpu_torch.data.vocab import build_vocab
    from hop_tpu_torch.infer import generate_long_form, make_forward
    from hop_tpu_torch.models.hop import build_hop_model, gru_input_size
    from hop_tpu_torch.models.llm_weights import install_llm_weights
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.train.llm import make_hop_train_steps
    from hop_tpu_torch.utils import safetensors_io
    from hop_tpu_torch.utils.checkpoint import CheckpointManager, differing_entries
    smi = _smi()
    cfg = llama_route_config()
    d = cfg.data
    paths = {}
    B = 256
    t0 = time.perf_counter()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed, device="cpu")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = copy.deepcopy(model_cpu).to(dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    n_backbone = sum(p.numel() for p in model.llm_model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    check(gru_input_size(cfg) == K2_LLAMA[2] == model.gru.weight_ih_l0.shape[1],
          f"the head's input is {gru_input_size(cfg)} wide")
    print(f"llama: TED HOPModel on the LLaMA-7B backbone at {cfg.llm.n_layers} layers "
          f"(dim {cfg.llm.dim}, {cfg.llm.n_heads} heads, MLP {cfg.llm.intermediate_dim}, "
          f"vocab {cfg.llm.vocab_size}): {n_params / 1e9:.3f} B params, {n_backbone / 1e9:.3f} "
          f"B frozen; built on the host from seed {seed} in {build_s:.1f} s, copied to the "
          f"card in {copy_s:.1f} s; the head's input {gru_input_size(cfg)} wide")

    # serving: the bs-256 forward on both GRU routes, the first samples
    # against the CPU, ms per forward and the backbone's share
    batch = serving_batch(cfg, B, seed, dev)

    def forward(b, m=model):
        with torch.inference_mode():
            return m(b["in_audio"], b["x_enc"], b["text"], b["pre_seq"],
                     b["vid_indices"], eps=b["eps"])[0]
    outs, ms = {}, {}
    for route in ("fused", "stack"):
        model.gru.kernel = route
        rcfg = llama_route_config(route)
        _reset_counts()
        outs[route] = forward(batch)
        torch.cuda.synchronize()
        paths[f"llama_serve_{route}"] = launches = _launch_counts()
        check(tuple(outs[route].shape) == (B, d.n_poses, d.pose_dim)
              and bool(torch.isfinite(outs[route]).all()),
              f"llama forward [{route}]: {tuple(outs[route].shape)}, or not finite")
        check(launches == forward_launches(rcfg),
              f"llama forward [{route}]: launches {launches}, want {forward_launches(rcfg)}")
        ms[route] = cuda_ms(lambda: forward(batch), reps=10, warmup=2)
    model.gru.kernel = "fused"
    gap = (outs["fused"] - outs["stack"]).abs().max().item()
    check(gap <= ROUTE_TOL, f"llama: the GRU routes differ by {gap} > {ROUTE_TOL}")
    n = LLAMA_CPU_SAMPLES
    small = {k: v[:n].cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    ref = forward(small, model_cpu)
    cpu_s = time.perf_counter() - t0
    diff = (outs["fused"][:n].cpu() - ref).abs().max().item()
    check(diff <= SERVE_TOL, f"llama: card vs CPU forward differ by {diff} > {SERVE_TOL}")
    del model_cpu, ref
    x = torch.randn(B, d.n_poses, cfg.llm.dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))

    def backbone():
        with torch.inference_mode():
            return model.llm_model(x)
    backbone_ms = cuda_ms(backbone, reps=10, warmup=2)
    own_fwd, _ = own_ms(lambda: forward(batch), "llama forward", n=3)
    own_backbone, _ = own_ms(backbone, "llama backbone", n=3)
    flops = backbone_flops(cfg, B * d.n_poses)
    share = (None if None in (own_fwd, own_backbone) else own_backbone / own_fwd)
    print(f"llama serve: bs {B} -> {tuple(outs['fused'].shape)} finite on both GRU routes "
          f"(launches fused {_nonzero(paths['llama_serve_fused'])}, stack "
          f"{_nonzero(paths['llama_serve_stack'])}); route vs route max_abs_diff {gap:.3e} "
          f"(tol {ROUTE_TOL:g}); card vs CPU (first {n}, plain versions, {cpu_s:.1f} s) "
          f"max_abs_diff {diff:.3e} (tol {SERVE_TOL:g}); ms per forward (CUDA-event median of "
          f"10): fused {ms['fused']:.2f}, stack {ms['stack']:.2f}; kernels of a forward "
          f"{fmt_ms(own_fwd)} ms, of the backbone alone {fmt_ms(own_backbone)} ms "
          f"(torch.profiler), its share {'not recorded' if share is None else f'{share:.3f}'}; "
          f"the backbone alone {backbone_ms:.2f} ms (events): {flops / 1e12:.2f} TFLOP of "
          f"bf16 products at {flops / backbone_ms / 1e9:.1f} TFLOP/s, "
          f"{flops / backbone_ms / 1e9 / (BF16_FLOPS / 1e12):.3f} of the dense peak; on {smi}")

    # one 20 s clip at bs 1 through generate_long_form
    clip = make_clip(cfg, seconds=LLAMA_CLIP_SECONDS, seed=1)
    lang = build_vocab("words", [clip.words], None, None, d.wordembed_dim)
    unit = d.n_poses / d.pose_resampling_fps
    stride = (d.n_poses - d.n_pre_poses) / d.pose_resampling_fps
    windows = math.ceil((LLAMA_CLIP_SECONDS - unit) / stride) + 1
    frames = windows * d.n_poses - (windows - 1) * d.n_pre_poses
    _reset_counts()
    t0 = time.perf_counter()
    out = generate_long_form(cfg, make_forward(model), clip.audio, clip.words,
                             clip.seed_dir_vec, lang, vid_index=0,
                             generator=torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    clip_s = time.perf_counter() - t0
    paths["llama_clip"] = launches = _launch_counts()
    check(out.shape == (frames, d.pose_dim) and np.isfinite(out).all(),
          f"llama clip: {out.shape}")
    check(launches == forward_launches(cfg, windows), f"llama clip: launches {launches}")
    print(f"llama clip: a {LLAMA_CLIP_SECONDS:.0f} s synthetic clip at bs 1 through "
          f"generate_long_form -> {frames} frames ({windows} windows, launches "
          f"{_nonzero(launches)}) in {clip_s:.3f} s (host clock)")

    # the loader: a fabricated HF checkpoint at the full width, bf16, in two
    # safetensors shards and as one pytorch_model.bin, installed into the
    # model, each bitwise the forward with the same weights copied in directly
    tmp = tempfile.mkdtemp(prefix="hop_llama_")
    tempdir, tempfile.tempdir = tempfile.tempdir, tmp
    try:
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        sd = {}
        for k, v in model.llm_model.state_dict().items():
            noise = torch.randn(v.shape, device=dev, generator=g)
            sd[k] = (1 + 0.1 * noise if k.endswith("norm.weight")
                     else 0.02 * noise).to(torch.bfloat16).cpu()
        written = write_llama_checkpoint(tmp, sd, cfg.llm)
        small = {k: v[:16] for k, v in batch.items()}
        with torch.no_grad():
            for k, p in model.llm_model.state_dict().items():
                p.copy_(sd[k])
        direct = forward(small)
        loads = {}
        for fmt in ("st", "bin"):
            with torch.no_grad():
                for p in model.llm_model.parameters():
                    p.zero_()
            torch.cuda.synchronize()
            info = install_llm_weights(model, written[fmt], cfg.llm)
            torch.cuda.synchronize()
            got = forward(small)
            check(torch.equal(got, direct), f"llama loader [{fmt}]: the forward differs "
                                            f"from the direct copy's by "
                                            f"{(got - direct).abs().max().item()}")
            loads[fmt] = info["bytes"] / 2 ** 20 / info["seconds"]
        print(f"llama loader: an HF LLaMA checkpoint at {cfg.llm.n_layers} layers, bf16, "
              f"written by the port's writer in {written['seconds']:.1f} s "
              f"({written['bytes'] / 2 ** 30:.2f} GiB: two safetensors shards + index, and a "
              f"pytorch_model.bin); install_llm_weights then a forward bitwise the forward "
              f"with the same weights copied in directly, from the shards "
              f"{loads['st']:.0f} MiB/s, from the .bin {loads['bin']:.0f} MiB/s (read, cast "
              f"and copied to the card, host clock)")

        # training: the fused GAN step at bs 256 on the fused GRU route
        disc = build_discriminator(cfg, seed + 1, dev)
        warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
        state = init_state()
        train_batch = make_train_batch(cfg, B, seed, N_SPEAKERS, dev)
        before = {k: v.detach().clone() for k, v in
                  list(model.state_dict().items()) + [("D." + k, v) for k, v in
                                                      disc.state_dict().items()]}
        noise_gen = torch.Generator().manual_seed(seed)
        name = "fused GAN step on the LLaMA backbone, fused route"
        state, metrics, launches, no_grad = _first_gan_step(
            cfg, model, disc, state, gan, train_batch, noise_gen, before, name)
        paths["llama_fused_step"] = launches
        del before
        step_ms, device_ms, busy, top, peak_gb = _step_times(gan, state, train_batch,
                                                             noise_gen)
        n_train = sum(p.numel() for p in _trainable(model).values())
        print(f"llama train [{name}]: bs {B}, {n_train / 1e6:.1f} M trainable generator "
              f"params: losses finite (" + ", ".join(
                  f"{k} {metrics[k].item():.4g}" for k in ("loss", "KLD", "DIV_REG", "gen", "dis"))
              + f"); every trainable param of both nets with a gradient moved "
              f"({len(no_grad)} without one), the backbone bit-unchanged; launches "
              f"{_nonzero(launches)}; {step_ms:.2f} ms per step (CUDA-event median of 10); "
              f"kernels {device_ms:.2f} ms per step, busy share {busy:.3f} (torch.profiler, "
              f"3 steps); peak memory {peak_gb:.2f} GiB; top kernels "
              + "; ".join(f"{k} {t:.2f} ms" for k, t in top))
        del state, gan, warmup, init_state, disc, model, train_batch, batch, x, outs
        torch.cuda.empty_cache()

        # the run: run_ted --llm-model LLAMA --llm-weights <the shards>, 2
        # epochs against 1 + --resume to 2, bit for bit; a resume without
        # --llm-weights refused; test_checkpoint on the run's checkpoint
        def argv(name, epochs, *extra):
            d_ = os.path.join(tmp, name)
            return (*RUN_ARGS, "--seed", str(seed), "--epochs", str(epochs),
                    "--llm-model", "LLAMA", "--llm-layers", str(LLAMA_RUN_LAYERS),
                    "--checkpoint-dir", d_, "--metrics", os.path.join(d_, "metrics.jsonl"),
                    *extra)
        weights = ("--llm-weights", written["st"])
        opened, read = [], safetensors_io.read
        safetensors_io.read = lambda f, names=None: opened.append(f) or read(f, names)
        _reset_counts()
        t0 = time.perf_counter()
        try:
            (state_a, best_a), out_a = _run_ted(argv("A", LLAMA_RUN_EPOCHS, *weights))
        finally:
            safetensors_io.read = read
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        paths["llama_run"] = launches = _launch_counts()
        check([os.path.basename(f) for f in opened] == ["model-00001-of-00002.safetensors"],
              f"llama run: at {LLAMA_RUN_LAYERS} layers it opened {opened}")
        t0 = time.perf_counter()
        _run_ted(argv("B", LLAMA_RUN_EPOCHS - 1, *weights))
        (state_b, best_b), out_b = _run_ted(argv("B", LLAMA_RUN_EPOCHS, "--resume", *weights))
        run_b_s = time.perf_counter() - t0
        check(f"resumed from checkpoint epoch {LLAMA_RUN_EPOCHS - 2}" in out_b,
              "llama run: B did not resume")
        check("loaded pretrained LLAMA backbone from" in out_a, "llama run: no backbone loaded")
        a_dir, b_dir = os.path.join(tmp, "A"), os.path.join(tmp, "B")
        diff = differing_entries(CheckpointManager(a_dir).restore(),
                                 CheckpointManager(b_dir).restore())
        check(not diff, f"llama run: 2 epochs and 1 + resume to 2 differ at {diff[:6]}")
        for f in ("metrics.jsonl", "best_metrics.json"):
            a, b = (open(os.path.join(x_, f)).read() for x_ in (a_dir, b_dir))
            check(a == b, f"llama run: {f} differs between A and B")
        check(best_a == best_b, f"llama run: best FGD {best_a} vs {best_b}")
        for st_ in (state_a, state_b):
            got = st_.model.llm_model.state_dict()
            check(all(torch.equal(got[k].cpu(), sd[k].float()) for k in got),
                  "llama run: the backbone is not the checkpoint's")
        rcfg = llama_route_config(n_layers=LLAMA_RUN_LAYERS)
        n_train = int(out_a.split("train samples: ")[1].split(",")[0])
        n_val = int(out_a.split("val: ")[1].split(",")[0])
        steps = n_train // B
        want = run_launches(rcfg.replace(loss=dataclasses.replace(rcfg.loss, warmup_epochs=0)),
                            LLAMA_RUN_EPOCHS, steps, -(-n_val // B),
                            state_a.disc.gru.num_layers)
        check(launches == want, f"llama run: launches {launches}, want {want}")
        meta = CheckpointManager(a_dir).run_metadata()
        check(meta["llm_weights"] == os.path.abspath(written["st"]), "llama run: metadata")
        del state_a, state_b
        try:
            _run_ted(argv("B", LLAMA_RUN_EPOCHS + 1, "--resume"))
            refused = ""
        except SystemExit as e:
            refused = str(e)
        check("llm_weights=None" in refused,
              f"llama run: a resume without --llm-weights was not refused ({refused!r})")

        _reset_counts()
        t0 = time.perf_counter()
        served = test_checkpoint.main(["--device", str(dev), "--checkpoint-dir", a_dir,
                                       "--seed", str(seed), "--clip-seconds",
                                       str(LLAMA_CLIP_SECONDS)])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        paths["llama_test_checkpoint"] = launches = _launch_counts()
        check(served.shape == (frames, d.pose_dim) and np.isfinite(served).all(),
              f"llama test_checkpoint: {served.shape}")
        check(launches == forward_launches(rcfg, windows),
              f"llama test_checkpoint: launches {launches}")
        print(f"llama run [python -m hop_tpu_torch.cli.run_ted --llm-model LLAMA --llm-layers "
              f"{LLAMA_RUN_LAYERS} --llm-weights <the shards>, 4096 wide, bs {B}, {n_train} "
              f"training windows ({steps} steps an epoch), {n_val} validation windows]: A "
              f"({LLAMA_RUN_EPOCHS} epochs, {run_a_s:.1f} s) and B ({LLAMA_RUN_EPOCHS - 1} + "
              f"--resume to {LLAMA_RUN_EPOCHS}, {run_b_s:.1f} s; host clock, builds, loads and "
              f"data included) end bit-identical (every checkpoint tensor, metrics.jsonl, "
              f"best_metrics.json); s of train steps an epoch "
              + ", ".join(f"{t:.3f}" for t in _epoch_seconds(out_a))
              + f"; the backbone the checkpoint's (one shard of two opened); launches "
              f"{_nonzero(paths['llama_run'])} as derived; a resume without --llm-weights "
              f"refused; test_checkpoint --checkpoint-dir <A> -> {served.shape} finite in "
              f"{serve_s:.1f} s (restore and reload included), launches {_nonzero(launches)}")
        return paths
    finally:
        tempfile.tempdir = tempdir
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 25: the baseline zoo (ROADMAP M13a) -------------------------------
# K2's and K3's shapes on the zoo's paths, (T, B, I, H, D) and (D, T, B, H)
ZOO_K2 = ((34, 256, 108, 300, 2),   # PoseGenerator's first layer, TED
          (34, 256, 207, 300, 2),   # the same, Expressive
          (34, 256, 600, 300, 2),   # the upper layers of every BiGRU(300)
          (36, 256, 300, 300, 2),   # the seq2seq encoder's first layer (36 words)
          (34, 256, 64, 300, 2),    # PoseDecoderGRU's first layer
          (34, 256, 64, 256, 1),    # ContextEncoder's GRU(256), one direction
          (34, 256, 256, 256, 1))   # its second layer
ZOO_K3 = ((2, 34, 256, 300), (2, 36, 256, 300), (1, 34, 256, 256))
ZOO_OTHERS = ("seq2seq", "speech2gesture", "joint_embedding", "gesture_autoencoder")
# the families whose epochs after the warmup run the GAN step (which
# speech2gesture's one step always is)
GAN_FAMILIES = ("multimodal_context", "AD_LLM", "hierarchy")
ZOO_VIDEOS = 20           # seeded 20 s clips: 520 windows, 2 steps an epoch at bs 256
ZOO_CPU_B = 8             # the card-vs-CPU steps
ZOO_RUN_EPOCHS = 2
# Card vs CPU, the same weights, batch and draws: f32 on both sides (TF32 off,
# K2's and K3's products 3xTF32), sums in other orders. Losses agree to
# ZOO_LOSS_TOL relative; each gradient tensor to ZOO_GRAD_TOL of its largest
# element (the CPU tests' rule), the warmup and the GAN step alike. A tensor
# below ZOO_ZERO_REL of its net's largest gradient is round-off of an exactly
# zero gradient (a convolution's bias in front of a BatchNorm; the
# WavEncoder's first sums B * 7891 positions) and is left out. The limits
# lie between the readings (losses at most 1.6e-5, gradients 2.2e-5, on
# both routes) and a planted fault, the generator GRU's output scaled by
# 1 + ZOO_FAULT (losses 1.5e-3, gradients 1.3e-3), which must fail both
# (NVIDIA H100 80GB HBM3, 700 W).
ZOO_LOSS_TOL = 1e-4
ZOO_GRAD_TOL = 1e-4
ZOO_FAULT = 1e-3
ZOO_ZERO_REL = 1e-4


def zoo_launches(model: str, net, kind: str, gru_kernel: str, disc=None) -> dict:
    """Kernel launches of one train step ("warmup" or "gan") or one
    validation forward ("eval") of a baseline family, from its nets.

    AD_LLM (HOP, the fused step): `step_launches` and `forward_launches` of
    its config. hierarchy: each stage's GRU layers run as the trimodal
    generator's do, times the stages: the cascade for the batch's speakers
    with a graph, the one for shuffled speakers and the GAN step's D phase
    without; the discriminator's three forwards with a graph.

    multimodal_context: the step's generator forward for the batch's
    speakers runs with a graph (its GRU layers forward with residuals, and
    backward), the one for shuffled speakers without (lean); the GAN step
    adds the D phase's generator forward (lean) and the discriminator's
    three forwards (real, fake, the G term), each with a graph and a
    backward. seq2seq: the encoder's layers with a graph. joint_embedding:
    the ContextEncoder's layers run with a graph that no loss reads (no
    backward), PoseDecoderGRU's with one; its validation decodes the poses'
    latent alone. speech2gesture and gesture_autoencoder run no GRU. On the
    fused route every forward is a K2 launch; on the stack route K3 (with
    residuals) or K3 lean."""
    if model == "AD_LLM":
        if kind == "eval":
            return forward_launches(net.cfg)
        return step_launches(net.cfg, disc.gru.num_layers, kind == "gan")
    res = lean = bwd = 0
    if model in ("multimodal_context", "hierarchy"):
        L = (net.gru.num_layers if model == "multimodal_context"
             else len(net.stages) * net.stages[0].gru.num_layers)
        if kind == "eval":
            lean = L
        else:
            res, lean, bwd = L, L, L
            if kind == "gan":
                D = disc.gru.num_layers
                res, lean, bwd = res + 3 * D, lean + L, bwd + 3 * D
    elif model == "seq2seq":
        L = net.encoder.gru.num_layers
        lean, res, bwd = (L, 0, 0) if kind == "eval" else (0, L, L)
    elif model == "joint_embedding":
        L = net.decoder.gru.num_layers
        if kind == "eval":
            lean = L
        else:
            res, bwd = net.context_encoder.gru.num_layers + L, L
    want = dict(ZERO_COUNTS)
    if gru_kernel == "stack":
        want.update(K3=res, K3_lean=lean, K3_bwd=bwd)
    else:
        want.update(K2=res + lean, K2_bwd=bwd)
    return want


def phase_zoo_kernels(dev, seed, k2_shapes=ZOO_K2, k3_shapes=ZOO_K3, label="zoo"):
    """K2 forward and backward at each layer shape of the zoo, and K3's
    forwards and backward at its BiGRU(300) and GRU(256) recurrences, against
    their plain versions; each call's ms, the backwards' kernels' own ms
    (torch.profiler; the forwards' short windows are seldom kept whole, and
    each retry costs a second), the plain version's ms, the bound and
    cuDNN's torch.nn.GRU at the same shape. `label` names the shapes' path
    (the zoo's by default, phase 27's "hierarchy")."""
    import torch
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import gru_stack as K3

    def own(fn, what):
        names = kernel_ms_by_name(fn)
        if not names:
            print(f"{what}: torch.profiler recorded no window whole in six")
        return (sum(names.values()) if names else None), names
    res = {k: {} for k in ("K2", "K2_bwd", "K3", "K3_lean", "K3_bwd")}
    for shape in k2_shapes:
        T, B, I, H, D = shape
        args = _k2_inputs(dev, seed, *shape)
        got = K2.gru_fused_layer_fwd(*args, with_residuals=True)
        again = K2.gru_fused_layer_fwd(*args, with_residuals=True)
        lean = K2.gru_fused_layer(*args)
        want = K2.plain_gru_fused_layer(*args, with_residuals=True)
        dout = torch.randn(D, T, B, H, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed + I))
        h_seq, r, z, n, hnb = got
        bwd_args = (dout, args[0], r, z, n, hnb, K2.hprev_of(h_seq, args[5]),
                    args[1], args[3])
        grads = K2.gru_fused_layer_bwd(*bwd_args)
        grads_again = K2.gru_fused_layer_bwd(*bwd_args)
        want_grads = K2.plain_gru_fused_layer_bwd(*bwd_args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again))
              and torch.equal(lean, got[0])
              and all(torch.equal(a, b) for a, b in zip(grads, grads_again)),
              f"K2 at the {label}'s {shape}: two calls differ")
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        check(err <= K2_TOL, f"K2 at the {label}'s {shape}: {err} > {K2_TOL}")
        rels = [rel_err(a, b) for a, b in zip(grads, want_grads)]
        rel = max(e[1] for e in rels)
        check(rel <= BWD_REL_TOL, f"K2 bwd at the {label}'s {shape}: {rel} > {BWD_REL_TOL} "
                                  f"relative")
        bwd_own, _ = own(lambda: K2.gru_fused_layer_bwd(*bwd_args), f"K2 bwd at {shape}")
        lib = gru_layer_yardstick(dev, seed, T, B, I, H, D)
        res["K2"][shape] = {
            "max_abs_err": err, "ms": cuda_ms(lambda: K2.gru_fused_layer(*args)),
            "plain_ms": cuda_ms(lambda: K2.plain_gru_fused_layer(*args), reps=5),
            "library_ms": lib["cudnn"][0],
            **bound(args, lean, 2.0 * T * B * D * 3 * H * (I + H), F32_FLOPS)}
        res["K2_bwd"][shape] = {
            "max_abs_err": max(e[0] for e in rels), "rel_err": rel,
            "ms": cuda_ms(lambda: K2.gru_fused_layer_bwd(*bwd_args), reps=10),
            "kernel_ms": bwd_own,
            "plain_ms": cuda_ms(lambda: K2.plain_gru_fused_layer_bwd(*bwd_args), reps=5),
            "library_ms": lib["cudnn_bwd"],
            **bound(bwd_args, grads, 2.0 * T * B * D * 3 * H * (2 * H + 2 * I), F32_FLOPS)}
        f, b = res["K2"][shape], res["K2_bwd"][shape]
        print(f"{label} K2 at (T, B, I, H, D) {shape} ({K2.recurrence_variant(H)}): forward "
              f"max_abs_err {err:.3e} (tol {K2_TOL:g}), lean {f['ms']:.3f} ms vs plain "
              f"{f['plain_ms']:.3f}, bound {f['bound_ms']:.3f} "
              f"by {f['bound_by']}, cuDNN {f['library_ms']:.3f}; backward rel err "
              f"{rel:.2e} (tol {BWD_REL_TOL:g}), {b['ms']:.3f} ms (its kernels "
              f"{fmt_ms(bwd_own)}) vs plain {b['plain_ms']:.3f}, bound {b['bound_ms']:.3f} "
              f"by {b['bound_by']}, cuDNN's backward alone {b['library_ms']:.3f}; bitwise "
              f"repeat")
    for shape in k3_shapes:
        D, T, B, H = shape
        args, g = _k3_inputs(dev, seed, *shape, torch.float32)
        full = K3.gru_stack_fwd(*args, with_residuals=True)
        again = K3.gru_stack_fwd(*args, with_residuals=True)
        lean = K3.gru_stack_fwd(*args)
        want = K3.plain_gru_stack(*args, with_residuals=True)
        h_seq, r, z, n, hnb = full
        bwd_args = (g, r, z, n, hnb, K2.hprev_of(h_seq, args[5]), args[3], torch.float32)
        grads = K3.gru_stack_bwd(*bwd_args)
        grads_again = K3.gru_stack_bwd(*bwd_args)
        want_grads = K3.plain_gru_stack_bwd(*bwd_args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(full, again))
              and torch.equal(lean, full[0])
              and all(torch.equal(a, b) for a, b in zip(grads, grads_again)),
              f"K3 at the {label}'s {shape}: two calls differ")
        err = max((a - b).abs().max().item() for a, b in zip(full, want))
        lean_err = (lean - want[0]).abs().max().item()
        check(max(err, lean_err) <= K3_TOL, f"K3 at the {label}'s {shape}: "
                                            f"{max(err, lean_err)} > {K3_TOL}")
        rels = [rel_err(a, b) for a, b in zip(grads, want_grads)]
        rel = max(e[1] for e in rels)
        check(rel <= BWD_REL_TOL, f"K3 bwd at the {label}'s {shape}: {rel} > {BWD_REL_TOL}")
        flops = 2.0 * T * B * D * 3 * H * H
        for key, fn, plain, e, result, ops in (
                ("K3", lambda: K3.gru_stack_fwd(*args, with_residuals=True),
                 lambda: K3.plain_gru_stack(*args, with_residuals=True), err, full, flops),
                ("K3_lean", lambda: K3.gru_stack_fwd(*args),
                 lambda: K3.plain_gru_stack(*args), lean_err, lean, flops),
                ("K3_bwd", lambda: K3.gru_stack_bwd(*bwd_args),
                 lambda: K3.plain_gru_stack_bwd(*bwd_args), max(x[0] for x in rels),
                 grads, 2 * flops)):
            res[key][shape] = {"max_abs_err": e, "ms": cuda_ms(fn, reps=10),
                               "plain_ms": cuda_ms(plain, reps=5), "library_ms": None,
                               **bound(bwd_args[:7] if key == "K3_bwd" else args, result,
                                       ops, F32_FLOPS)}
        res["K3_bwd"][shape]["kernel_ms"] = own(
            lambda: K3.gru_stack_bwd(*bwd_args), f"K3_bwd at {shape}")[0]
        print(f"{label} K3 at (D, T, B, H) {shape}: forward max_abs_err {err:.3e}, lean "
              f"{lean_err:.3e} (tol {K3_TOL:g}); backward rel err {rel:.2e}; bitwise "
              f"repeat; ms (its kernels) / plain / bound: " + "; ".join(
                  f"{k} {res[k][shape]['ms']:.3f} "
                  + (f"({fmt_ms(res[k][shape]['kernel_ms'])}) " if k == "K3_bwd" else "")
                  + f"/ {res[k][shape]['plain_ms']:.3f} / {res[k][shape]['bound_ms']:.3f} by "
                  f"{res[k][shape]['bound_by']}" for k in ("K3", "K3_lean", "K3_bwd")))
    return res


def _zoo_records(cfg, root: str, seed: int) -> tuple:
    """ZOO_VIDEOS seeded 20 s clips as records, the first video also the
    validation split (as `load_datasets` writes them for `--data
    synthetic`), once for every run and step of the phase: the flags that
    point a run at them."""
    from hop_tpu_torch.data import synthetic
    from hop_tpu_torch.data.preprocessor import DataPreprocessor
    videos = synthetic.make_source_clips(cfg, n_videos=ZOO_VIDEOS, clip_seconds=20.0,
                                         seed=seed)
    os.makedirs(root)
    for split, vids in (("train", videos), ("val", videos[:1])):
        DataPreprocessor(cfg.data, os.path.join(root, split)).run(vids)
    return ("--data", os.path.join(root, "train"), "--val-data", os.path.join(root, "val"))


class _Zoo:
    """A config's datasets, once, and the nets and steps of a family on a GRU
    route built from them as `train_main` builds them."""

    def __init__(self, cfg, data: tuple, seed: int, dev):
        import numpy as np
        from hop_tpu_torch.cli import common as C
        self.cfg, self.data, self.seed, self.dev = cfg, data, seed, dev
        args = C.base_parser("phase 25").parse_args(list(data))
        with contextlib.redirect_stdout(io.StringIO()):
            self.train_ds, _, self.lang = C.load_datasets(C.apply_overrides(cfg, args), args)
        self.n_speakers = max(self.train_ds.speaker_model.n_words, 1)
        self.host = self.train_ds.make_batch(np.arange(cfg.train.batch_size))
        self.witnessed = {}     # `_zoo_step_vs_cpu`'s f64 witness of each family

    def build(self, model: str, gru_kernel: str = "fused", device=None, hop=None,
              mesh=None):
        """(config, state, warmup step, GAN step or None, bs-256 batch); `hop`:
        HOPConfig fields to replace (the ablations); on a rank of `mesh`, the
        rank's nets and steps and its rows of the batch."""
        from hop_tpu_torch.cli import common as C
        from hop_tpu_torch.cli.train_main import build_model_and_steps
        from hop_tpu_torch.parallel import batch_rows
        device = device or self.dev
        args = C.base_parser("phase 25").parse_args(
            [*self.data, "--model", model, "--seed", str(self.seed), "--gru-kernel",
             gru_kernel])
        cfg = C.apply_overrides(self.cfg, args)
        cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, **(hop or {})))
        with contextlib.redirect_stdout(io.StringIO()):
            state, warmup, gan, _ = build_model_and_steps(cfg, args, self.lang,
                                                          self.n_speakers, device, mesh)
        batch = C.device_batch(batch_rows(self.host, mesh), cfg,
                               keys=C.MODEL_BATCH_KEYS[model], device=device)
        return cfg, state, warmup, gan, batch


def _zoo_grads(state) -> dict:
    nets = {"G": state.model}
    if hasattr(state, "disc"):
        nets["D"] = state.disc
    return {f"{n}.{k}": p.grad.detach().cpu() for n, net in nets.items()
            for k, p in net.named_parameters() if p.grad is not None}


def _zoo_errs(card, cpu, scale: str = "tensor") -> tuple:
    """Card vs CPU, each (metrics, gradients): the losses' largest relative
    error and each gradient tensor's error over its largest element (`scale`
    "tensor") or over its net's largest gradient ("net"), the tensors below
    ZOO_ZERO_REL of their net's largest gradient left out."""
    (m_card, g_card), (m_cpu, g_cpu) = card, cpu
    check(set(m_card) == set(m_cpu) and set(g_card) == set(g_cpu),
          "zoo step: card and CPU differ in what they return")
    loss_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu)
    errs = {}
    for net in ("G.", "D."):
        mine = {k: g for k, g in g_cpu.items() if k.startswith(net)}
        if not mine:
            continue
        top = max(g.abs().max().item() for g in mine.values())
        errs.update({k: (rel_err(g_card[k], g)[1] if scale == "tensor"
                         else rel_err(g_card[k], g)[0] / top)
                     for k, g in mine.items() if g.abs().max().item() >= ZOO_ZERO_REL * top})
    return loss_err, errs


def _step_noise(model: str, state, cfg, generator, B: int):
    """A step's draws for `model`'s step from a CPU generator."""
    from hop_tpu_torch.train.llm import StepNoise
    if model == "AD_LLM":
        return StepNoise.draw(generator, cfg, B)
    if model == "hierarchy":
        return StepNoise.draw_stages(generator, len(state.model.stages), B, 16)
    return StepNoise.draw_speakers(generator, B, 16)


def _last_gru(model: str, state):
    """The generator's GRU whose output a planted fault scales."""
    return state.model.stages[-1].gru if model == "hierarchy" else state.model.gru


def _as_f64(state, batch, noise):
    """The CPU step's nets, optimizer state, batch and draws in f64 (the
    precision witness of `_zoo_step_vs_cpu`)."""
    import torch
    for net in (state.model, state.disc):
        net.double()
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    noise = dataclasses.replace(noise, **{
        f.name: getattr(noise, f.name).double() for f in dataclasses.fields(noise)
        if isinstance(getattr(noise, f.name), torch.Tensor)
        and getattr(noise, f.name).is_floating_point()})
    return batch, noise


def _worst(errs: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {errs[k]:.2e}" for k in sorted(errs, key=errs.get)[::-1][:n])


def _zoo_step_vs_cpu(zoo, kind: str, gru_kernel: str, model: str = "multimodal_context",
                     loss_tol: float = ZOO_LOSS_TOL, grad_tol: float = ZOO_GRAD_TOL,
                     hop=None, label: str = "zoo", scale: str = "tensor",
                     fault: bool = True, apart: dict = None, witness: tuple = None,
                     reuse_witness: bool = False):
    """One warmup or GAN step of `model` at bs ZOO_CPU_B on the card and on
    the CPU from the same fresh state, batch and draws: losses and
    gradients. Dropout is off on both sides: its masks come from each
    device's own torch.Generator, whose CUDA and CPU streams differ. Each
    gradient tensor's error is taken over its largest element (`scale`
    "tensor") or over its net's largest gradient ("net"; `_zoo_errs`), and
    held to `grad_tol`, but for the tensors held apart:
      * `apart` {name prefix: limit}: those tensors to their own limit;
      * `witness` (name prefix, tol): those tensors against the same step
        on the CPU in f64, each to the larger of `tol` of its net's largest
        gradient and WITNESS_RATIO times the CPU's own f32 error; with
        `reuse_witness`, against the CPU's f32 step instead, each to its
        limit and the CPU's f32 error as the last witnessed step of `model`
        measured them (the warmup after the GAN step, whose generator loss
        holds the warmup's).
    With `fault`, the card's step runs again with the generator's (last)
    GRU's output scaled by 1 + ZOO_FAULT, a planted fault that the loss
    limit and `grad_tol` must both catch."""
    import torch
    apart = dict(apart or {})
    builds = []

    def run(device, fault=0.0, f64=False):
        t = time.perf_counter()
        cfg, state, warmup, gan, batch = zoo.build(model, gru_kernel, device, hop)
        builds.append(time.perf_counter() - t)
        for m in (*state.model.modules(), *state.disc.modules()):
            for rate in ("dropout", "emb_dropout", "dropout_rate", "attention_dropout"):
                if isinstance(getattr(m, rate, None), float):
                    setattr(m, rate, 0.0)
        if fault:
            _last_gru(model, state).register_forward_hook(
                lambda mod, args, out: (out[0] * (1.0 + fault), out[1]))
        batch = {k: v[:ZOO_CPU_B] for k, v in batch.items()}
        noise = _step_noise(model, state, cfg, torch.Generator().manual_seed(zoo.seed + 2),
                            ZOO_CPU_B)
        if f64:
            batch, noise = _as_f64(state, batch, noise)
        _, metrics = (warmup if kind == "warmup" else gan)(state, batch, noise)
        return {k: v.item() for k, v in metrics.items()}, _zoo_grads(state)

    def limit_of(k):
        return next((tol for p, tol in apart.items() if k.startswith(p)), None)
    t0 = time.perf_counter()
    cpu = run(torch.device("cpu"))
    card = run(zoo.dev)
    name = f"{label} {model} {kind} step ({gru_kernel})"
    loss_err, errs = _zoo_errs(card, cpu, scale)
    held = {k: e for k, e in errs.items() if limit_of(k) is None
            and not (witness and k.startswith(witness[0]))}
    worst = max(held, key=held.get)
    check(loss_err <= loss_tol, f"{name} card vs CPU losses: {loss_err} > {loss_tol} "
                                f"relative")
    check(held[worst] <= grad_tol, f"{name} card vs CPU gradients: {_worst(held)} "
                                   f"> {grad_tol}")
    notes = []
    for p, tol in apart.items():
        mine = {k: e for k, e in errs.items() if k.startswith(p)}
        if mine:
            check(max(mine.values()) <= tol, f"{name}: {p}* card vs CPU {_worst(mine)} > {tol}")
            notes.append(f"{p}* {_worst(mine, 1)} (tol {tol:g})")
    if witness and reuse_witness:
        prefix, _ = witness
        lims, w_cpu = zoo.witnessed[model]
        n_errs = _zoo_errs(card, cpu, "net")[1]
        mine = {k: e for k, e in n_errs.items() if k.startswith(prefix)}
        bound = {k: lims.get(k, witness[1]) + w_cpu.get(k, 0.0) for k in mine}
        over = {k: e / bound[k] for k, e in mine.items()}
        top = max(over, key=over.get)
        check(over[top] <= 1.0, f"{name}: {top} card vs CPU {mine[top]} > {bound[top]}, the "
                                f"witnessed limit plus the CPU's f32 error")
        notes.append(
            f"{prefix}* ({len(mine)} tensors) card vs CPU over its net's largest "
            f"{_worst(mine)}, each held to its limit from the GAN step's f64 witness plus the "
            f"CPU's f32 error there, closest {top} at {over[top]:.2f} of it")
    elif witness:
        prefix, tol = witness
        f64 = run(torch.device("cpu"), f64=True)
        (w_loss, w_card), (w_cpu_loss, w_cpu) = (_zoo_errs(x, f64, "net") for x in (card, cpu))
        lims = {k: max(tol, WITNESS_RATIO * e) for k, e in w_cpu.items() if k.startswith(prefix)}
        zoo.witnessed[model] = lims, w_cpu
        over = {k: w_card[k] / lim for k, lim in lims.items()}
        top = max(over, key=over.get)
        check(over[top] <= 1.0, f"{name}: {top} against the f64 witness: card {w_card[top]} > "
                                f"{lims[top]} (the CPU's f32 {w_cpu[top]})")
        notes.append(
            f"{prefix}* ({len(lims)} tensors) against the same step in f64 on the CPU, over "
            f"its net's largest: card {_worst({k: w_card[k] for k in lims})}, the CPU's own "
            f"f32 {_worst({k: w_cpu[k] for k in lims})}, each held to the larger of {tol:g} "
            f"and {WITNESS_RATIO:g}x the CPU's, closest {top} at {over[top]:.2f} of its "
            f"limit; losses against f64: card {w_loss:.2e}, CPU {w_cpu_loss:.2e}")
    planted = ""
    if fault:
        f_loss, f_errs = _zoo_errs(run(zoo.dev, ZOO_FAULT), cpu, scale)
        f_held = {k: e for k, e in f_errs.items() if k in held}
        f_worst = max(f_held, key=f_held.get)
        check(f_loss > loss_tol and f_held[f_worst] > grad_tol,
              f"{name}: the planted fault (the GRU's output times 1 + {ZOO_FAULT:g}) "
              f"passes the limits: losses {f_loss}, gradients {_worst(f_held)}")
        planted = (f"; the planted fault (the GRU's output times 1 + {ZOO_FAULT:g}): losses "
                   f"{f_loss:.2e}, gradients {_worst(f_held)}, caught by both limits")
    print(f"{label} {model} {kind} step, {gru_kernel} route, bs {ZOO_CPU_B}, card vs "
          f"CPU from one state: losses rel err {loss_err:.2e} (tol {loss_tol:g}); "
          f"gradients of {len(errs)}/{len(cpu[1])} tensors (the rest round-off of exact "
          f"zeros), worst over its {scale}'s largest {_worst(held)} (tol {grad_tol:g})"
          + "".join(f"; apart: {n}" for n in notes) + f"{planted}; "
          f"{time.perf_counter() - t0:.1f} s (builds " + ", ".join(f"{b:.1f}" for b in builds)
          + ")")


def _zoo_step(zoo, model: str, gru_kernel: str, kind: str, label: str, hop=None,
              reps: int = 5, phase: str = "zoo", profiled: int = 2, host_ops: bool = True,
              warm: int = 1):
    """One bs-256 step on the card: launches as `zoo_launches` derives them,
    finite losses, every parameter with a gradient moved; then ms a step
    (CUDA events, `reps` steps), its kernels' ms, the busy share and the peak
    of allocated memory (torch.profiler, `profiled` steps). Returns the
    launches."""
    import torch
    t0 = time.perf_counter()
    cfg, state, warmup, gan, batch = zoo.build(model, gru_kernel, hop=hop)
    built = time.perf_counter() - t0
    step = warmup if kind == "warmup" else gan
    disc = getattr(state, "disc", None)
    nets = [state.model] + ([disc] if disc is not None else [])
    before = [{k: p.detach().clone() for k, p in net.named_parameters()} for net in nets]
    rng = torch.Generator().manual_seed(zoo.seed)
    _reset_counts()
    state, metrics = step(state, batch, rng)
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = zoo_launches(model, state.model, kind, gru_kernel, disc)
    check(launches == want, f"{phase} {label}: launches {launches}, want {want}")
    for k, v in metrics.items():
        check(bool(torch.isfinite(v)), f"{phase} {label}: {k} = {v.item()}")
    moved = 0
    for net, was in zip(nets, before):
        for k, p in net.named_parameters():
            # Adam leaves a weight whose gradient is exactly zero where it was
            if p.grad is not None and bool(p.grad.any()):
                check(not torch.equal(p.detach(), was[k]), f"{phase} {label}: {k} did not move")
                moved += 1

    def one():
        step(state, batch, rng)
    ms = cuda_ms(one, reps=reps, warmup=warm)
    torch.cuda.reset_peak_memory_stats()
    busy, device_ms, top = _busy_share(one, profiled, ms, host_ops)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{phase} {label} [{cfg.data.dataset}, bs {cfg.train.batch_size}]: losses "
          + ", ".join(f"{k} {v.item():.4g}" for k, v in metrics.items())
          + f"; {moved} parameters with a non-zero gradient, each moved; launches "
          f"{_nonzero(launches)} as derived; {ms:.2f} ms a step (CUDA-event median of "
          f"{reps}), kernels {device_ms:.2f} ms, busy share {busy:.3f}, peak {peak:.2f} GiB "
          f"allocated (torch.profiler, {profiled} step{'s' if profiled > 1 else ''}"
          + ("" if host_ops else ", the card's activity alone") + "); "
          f"top: " + ", ".join(f"{k} {t:.2f}" for k, t in top[:4])
          + f"; {time.perf_counter() - t0:.1f} s (build {built:.1f})")
    return launches


def _zoo_run_launches(model: str, state, out: str, epochs: int, gru_kernel="fused") -> dict:
    """A run's launches from its steps (warmup in epoch 0, GAN after where the
    family has one) and its validation batches."""
    n_train = int(out.split("train samples: ")[1].split(",")[0])
    n_val = int(out.split("val: ")[1].split(",")[0])
    bs = int(out.split("batch: ")[1].split(",")[0])
    steps, val_batches = n_train // bs, -(-n_val // bs)
    disc = getattr(state, "disc", None)
    total = dict(ZERO_COUNTS)
    for epoch in range(epochs):
        kind = "gan" if model in GAN_FAMILIES and epoch > 0 else "warmup"
        for counts, n in ((zoo_launches(model, state.model, kind, gru_kernel, disc), steps),
                          (zoo_launches(model, state.model, "eval", gru_kernel), val_batches)):
            for k, v in counts.items():
                total[k] += v * n
    return total


def _run_argv(zoo, model, directory, epochs, prefetch, seed, dev, *extra):
    """A training entry point's arguments for a run of `model` on `zoo`'s
    records into `directory`."""
    return (*zoo.data, "--model", model, "--device", str(dev), "--seed", str(seed),
            "--warmup-epochs", "0", "--log-every", "1", "--epochs", str(epochs),
            "--prefetch", str(prefetch), "--checkpoint-dir", directory,
            "--metrics", os.path.join(directory, "metrics.jsonl"), *extra)


def _resume_run(entry, zoo, model, tmp, seed, dev, smi, phase="zoo") -> dict:
    """`entry --model model`: ZOO_RUN_EPOCHS epochs (A) against 1 + --resume
    to ZOO_RUN_EPOCHS (B, prefetch 2, under --transfer-guard disallow: no
    step waits for the card), bit for bit: the last checkpoint,
    metrics.jsonl, best_metrics.json, best FGD. Returns A's launches, held to
    their derivation."""
    import torch
    from hop_tpu_torch.utils.checkpoint import CheckpointManager, differing_entries
    name = f"{entry.__name__.split('.')[-1]} {model}"
    a_dir, b_dir = (os.path.join(tmp, f"{phase}_{model}_{zoo.cfg.data.dataset}{x}")
                    for x in ("_A", "_B"))
    _reset_counts()
    t1 = time.perf_counter()
    (state_a, best_a), out_a = _run_entry(entry, _run_argv(zoo, model, a_dir, ZOO_RUN_EPOCHS,
                                                           0, seed, dev))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = _launch_counts()
    guard = ("--transfer-guard", "disallow")
    _run_entry(entry, _run_argv(zoo, model, b_dir, 1, 2, seed, dev, *guard))
    (state_b, best_b), out_b = _run_entry(entry, _run_argv(
        zoo, model, b_dir, ZOO_RUN_EPOCHS, 2, seed, dev, "--resume", *guard))
    check("resumed from checkpoint epoch 0" in out_b, f"{phase} run {name}: no resume")
    ck_a, ck_b = CheckpointManager(a_dir), CheckpointManager(b_dir)
    check(ck_a.latest_step() == ck_b.latest_step() == ZOO_RUN_EPOCHS - 1,
          f"{phase} run {name}: latest steps {ck_a.latest_step()}, {ck_b.latest_step()}")
    diff = differing_entries(ck_a.restore(), ck_b.restore())
    check(not diff, f"{phase} run {name}: 2 epochs and 1 + resume differ at {diff[:6]}")
    for f in ("metrics.jsonl", "best_metrics.json"):
        a, b = (open(os.path.join(d, f)).read() for d in (a_dir, b_dir))
        check(a == b, f"{phase} run {name}: {f} differs:\n{a}\n{b}")
    check(best_a == best_b, f"{phase} run {name}: best FGD {best_a} vs {best_b}")
    want = _zoo_run_launches(model, state_a, out_a, ZOO_RUN_EPOCHS)
    check(launches == want, f"{phase} run {name}: launches {launches}, want {want}")
    print(f"{phase} run [python -m hop_tpu_torch.cli.{entry.__name__.split('.')[-1]} --model "
          f"{model}, {zoo.cfg.data.dataset} full width, bs {zoo.cfg.train.batch_size}]: "
          f"{ZOO_RUN_EPOCHS} epochs and 1 + --resume to {ZOO_RUN_EPOCHS} (prefetch 2, "
          f"--transfer-guard disallow) end bit-identical (the last checkpoint, "
          f"metrics.jsonl, best_metrics.json; best FGD {best_a:.6g}); launches "
          f"{_nonzero(launches)} as derived; {run_s:.1f} s (host clock, build and data "
          f"included); s of train steps an epoch "
          + ", ".join(f"{t:.3f}" for t in _epoch_seconds(out_a))
          + "; s a validation pass "
          + ", ".join(f"{t:.3f}" for t in _validation_seconds(out_a)) + f"; on {smi}")
    return launches


def zoo_data(dev, seed, tmp: str) -> tuple:
    """The TED and Expressive records of phases 25-27 under `tmp`, and a
    `_Zoo` of each."""
    from hop_tpu_torch.config import expressive_config, ted_config
    t0 = time.perf_counter()
    ted = _Zoo(ted_config(), _zoo_records(ted_config(), os.path.join(tmp, "ted"), seed),
               seed, dev)
    expr = _Zoo(expressive_config(),
                _zoo_records(expressive_config(), os.path.join(tmp, "expr"), seed),
                seed, dev)
    print(f"zoo: records of {ZOO_VIDEOS} seeded 20 s clips, TED and Expressive, in "
          f"{time.perf_counter() - t0:.1f} s; {len(ted.train_ds)} training windows, "
          f"vocabulary {ted.lang.n_words} words, {ted.n_speakers} speakers")
    return ted, expr


def phase_zoo(dev, seed, ted, expr, tmp):
    """Phase 25 on `zoo_data`'s records under `tmp`. Returns the launches of
    each driven path."""
    import torch
    from hop_tpu_torch.cli import run_expressive, run_ted
    smi = _smi()
    paths = {}
    t0 = time.perf_counter()
    # the trimodal GAN on both GRU routes: card vs CPU, then at bs 256
    for gru_kernel in ("fused", "stack"):
        for kind in ("warmup", "gan"):
            _zoo_step_vs_cpu(ted, kind, gru_kernel, fault=gru_kernel == "fused")
            paths[f"zoo_mm_{kind}_{gru_kernel}"] = _zoo_step(
                ted, "multimodal_context", gru_kernel, kind,
                f"multimodal_context {kind} step, {gru_kernel} route")
    # one step of each other family on the fused route
    for model in ZOO_OTHERS:
        paths[f"zoo_{model}_step"] = _zoo_step(ted, model, "fused", "warmup",
                                               f"{model} step")
    paths["zoo_motion_ae_step"] = _zoo_step(expr, "gesture_autoencoder", "fused",
                                            "warmup", "gesture_autoencoder (MotionAE) step")
    # yardstick: seq2seq's step with torch's embedding backward (atomics,
    # no repeat) in place of WordEmbedding's ordered one
    from unittest import mock
    from hop_tpu_torch.models.common import WordEmbedding
    with mock.patch.object(WordEmbedding, "forward", torch.nn.Embedding.forward):
        _zoo_step(ted, "seq2seq", "fused", "warmup",
                  "seq2seq step, torch's embedding backward (yardstick)")

    # run_ted: 2 epochs against 1 + --resume to 2, bit for bit
    for model in ("multimodal_context", "seq2seq"):
        paths[f"zoo_run_{model}"] = _resume_run(run_ted, ted, model, tmp, seed, dev,
                                                smi)
    _reset_counts()
    (state, best), out = _run_entry(run_expressive, _run_argv(
        expr, "multimodal_context", os.path.join(tmp, "expressive"), 1, 0, seed, dev))
    torch.cuda.synchronize()
    launches = paths["zoo_run_expressive"] = _launch_counts()
    want = _zoo_run_launches("multimodal_context", state, out, 1)
    check(launches == want, f"zoo run_expressive: launches {launches}, want {want}")
    check("[VAL] loss:" in out and math.isfinite(best),
          f"zoo run_expressive: best FGD {best}")
    print(f"zoo run [python -m hop_tpu_torch.cli.run_expressive --model "
          f"multimodal_context, pose_dim {expr.cfg.data.pose_dim}, bs "
          f"{expr.cfg.train.batch_size}]: 1 epoch, FGD {best:.6g}, launches "
          f"{_nonzero(launches)} as derived; s of train steps "
          + ", ".join(f"{t:.3f}" for t in _epoch_seconds(out)))
    print(f"zoo: phase 25 in {time.perf_counter() - t0:.1f} s on {smi}")
    return paths


# ---- phase 26: HOP on TED Expressive and HOP's ablations (ROADMAP M12) -------
HOP_ABLATIONS = {"no_gwnet": {"use_gwnet": False},
                 "no_reprogramming": {"use_reprogramming": False}}
# Card vs CPU at bs 8 from one state, dropout off (phase 25's rule), the
# planted fault (the generator's last GRU's output times 1 + ZOO_FAULT) in
# the GAN step (the ablations: their warmup step). Readings on an NVIDIA H100
# 80GB HBM3 at 700.00 W. HOP: each gradient tensor over its net's largest
# gradient, to EXPR_GRAD_TOL (readings at most 4.0e-4, the fault 6.1e-4 to
# 7.4e-4); held apart, the tensors whose gradients are products of bf16
# operands (the backbone's bf16 output, K1's bf16 reads), rounded at other
# places on the two devices (2.1e-3), and in the GAN step the
# discriminator, whose real and fake terms cancel in D.out (1.25e-3); the
# losses to EXPR_LOSS_TOL (readings at most 9.1e-5, the fault 1.8e-3). The
# hierarchy: phase 25's rule, each tensor to 1e-4 of its largest element
# (readings at most 4.6e-5, the fault's worst 8.7e-3 and 5.6e-2), but the ResNetSE,
# whose convolution gradients f32 does not resolve on either device (the
# first sums a dB-scale spectrogram against gradients its BatchNorm makes
# sum to ~0; on the card cuDNN's deterministic algorithms are FFTs): the
# CPU's own f32 lies up to 2.2e-3 of the net's largest from the same step
# in f64, the card's up to 2.7e-3, so these are held against f64 (HIER_AUDIO,
# WITNESS_RATIO); the losses to HIER_LOSS_TOL (readings 1.8e-5, the fault
# 1.6e-3).
EXPR_LOSS_TOL = 3e-4
EXPR_GRAD_TOL = 5e-4
EXPR_BF16 = {p: 5e-3 for p in ("G.mapping_layer.", "G.reprogramming_layer.",
                               "G.align_layer.")}
EXPR_DISC_TOL = 2.5e-3
HIER_LOSS_TOL = 1e-4
HIER_AUDIO = ("G.audio.", 1.5e-3)
WITNESS_RATIO = 2.0


def _hop_forward(zoo, label: str, hop=None, phase: str = "expressive") -> dict:
    """HOP's bs-256 forward (eval mode, no graph) on `zoo`'s config: launches
    as `forward_launches` derives them, finite poses of the config's width,
    ms (CUDA events). Returns the launches."""
    import torch
    from hop_tpu_torch.models.hop import gru_input_size
    cfg, state, _, _, batch = zoo.build("AD_LLM", hop=hop)
    model = state.model.eval()
    B = batch["target_vec"].shape[0]
    eps = torch.zeros(B, cfg.hop.z_size, device=zoo.dev)

    def forward():
        with torch.inference_mode():
            return model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                         batch["target_vec"][:, :cfg.data.n_seed_frames],
                         batch["vid_indices"], eps=eps)[0]
    _reset_counts()
    out = forward()
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = forward_launches(cfg)
    check(launches == want, f"{phase} HOP forward {label}: launches {launches}, want {want}")
    check(tuple(out.shape) == (B, cfg.data.n_poses, cfg.data.pose_dim)
          and bool(torch.isfinite(out).all()), f"{phase} HOP forward {label}: {out.shape}")
    ms = cuda_ms(forward, reps=5, warmup=1)
    print(f"{phase} HOP forward, {label} [{cfg.data.dataset}, bs {B}, the head's input "
          f"{gru_input_size(cfg)} wide]: {tuple(out.shape)} finite; launches "
          f"{_nonzero(launches)} as derived; {ms:.2f} ms (CUDA-event median of 5)")
    return launches


def phase_expressive(dev, seed, ted, expr, tmp):
    """Phase 26 on `zoo_data`'s records. Returns the launches of each driven
    path."""
    from hop_tpu_torch.cli import run_expressive
    smi = _smi()
    paths = {}
    t0 = time.perf_counter()
    paths["expr_serve"] = _hop_forward(expr, "fused route")
    for gru_kernel in ("fused", "stack"):
        paths[f"expr_gan_{gru_kernel}"] = _zoo_step(
            expr, "AD_LLM", gru_kernel, "gan", f"HOP fused GAN step, {gru_kernel} route",
            reps=3, phase="expressive", profiled=1, host_ops=False, warm=0)
    # the planted fault in the GAN step, whose generator loss is the warmup's
    # plus the G term
    for kind in ("warmup", "gan"):
        _zoo_step_vs_cpu(expr, kind, "fused", "AD_LLM", EXPR_LOSS_TOL, EXPR_GRAD_TOL,
                         label="expressive", scale="net", fault=kind == "gan",
                         apart={**EXPR_BF16, "D.": EXPR_DISC_TOL})
    paths["expr_run"] = _resume_run(run_expressive, expr, "AD_LLM", tmp, seed, dev, smi,
                                    "expressive")
    for name, hop in HOP_ABLATIONS.items():
        paths[f"ablation_{name}_serve"] = _hop_forward(ted, name, hop, "ablation")
        paths[f"ablation_{name}_gan"] = _zoo_step(
            ted, "AD_LLM", "fused", "gan", f"HOP {name} fused GAN step", hop, reps=3,
            phase="ablation", profiled=1, host_ops=False, warm=0)
        _zoo_step_vs_cpu(ted, "warmup", "fused", "AD_LLM", EXPR_LOSS_TOL, EXPR_GRAD_TOL, hop,
                         label=f"ablation {name}", scale="net", apart=EXPR_BF16)
    print(f"expressive: phase 26 in {time.perf_counter() - t0:.1f} s on {smi}")
    return paths


# ---- phase 27: the hierarchy (HA2G, ROADMAP M13b) ----------------------------
# K2 at the cascade's first layers (T, B, I, H, D): stage k's input is its
# bones' dir-vecs and flag, the audio blend (32), the text features (32) and
# z (16); TED's stages 1-2, Expressive's 1-5 (the last stages' 108 and 207
# are phase 25's PoseGenerator shapes, the upper layers its 600)
HIER_K2 = tuple((34, 256, I, 300, 2) for I in (96, 102, 105, 111, 117, 147, 177))
H36M_EPOCHS = 2


def write_h36m_npz(path: str, seed: int) -> None:
    """A fabricated Human3.6M `positions_3d` npz (the reference's
    h36m_loader.py:31 format): one training subject (S1) and one test
    subject (S9), two actions of 400 frames of 32 joints each, random walks."""
    import numpy as np
    rng = np.random.default_rng(seed)
    positions = {}
    for subject in ("S1", "S9"):
        positions[subject] = {
            f"act{a}": (rng.standard_normal((1, 32, 3)) * 0.2 + np.cumsum(
                rng.standard_normal((400, 32, 3)) * 0.003, axis=0)).astype(np.float32)
            for a in range(2)}
    np.savez(path, positions_3d=np.array(positions, dtype=object))


def phase_hierarchy(dev, seed, ted, expr, tmp):
    """Phase 27 on `zoo_data`'s records. Returns the launches of each driven
    path."""
    from hop_tpu_torch.cli import run_expressive, run_ted, train_h36m_ae
    from hop_tpu_torch.eval.export_eval_net import export
    smi = _smi()
    paths = {}
    t0 = time.perf_counter()
    for zoo in (ted, expr):
        ds = zoo.cfg.data.dataset
        # both kinds on the fused route, the GAN step (a superset) on the stack
        for gru_kernel, kinds in (("fused", ("warmup", "gan")), ("stack", ("gan",))):
            for kind in kinds:
                paths[f"hier_{ds}_{kind}_{gru_kernel}"] = _zoo_step(
                    zoo, "hierarchy", gru_kernel, kind,
                    f"{kind} step, {gru_kernel} route", reps=3, phase="hierarchy",
                    profiled=1, host_ops=False, warm=0)
        for kind in ("gan", "warmup"):
            _zoo_step_vs_cpu(zoo, kind, "fused", "hierarchy", HIER_LOSS_TOL,
                             label=f"hierarchy {ds}", fault=kind == "gan", witness=HIER_AUDIO,
                             reuse_witness=kind == "warmup")
    paths["hier_run_ted"] = _resume_run(run_ted, ted, "hierarchy", tmp, seed, dev, smi,
                                        "hierarchy")
    paths["hier_run_expressive"] = _resume_run(run_expressive, expr, "hierarchy", tmp, seed,
                                               dev, smi, "hierarchy")
    # the FGD feature net's loop: H36M -> train_h36m_ae -> export_eval_net ->
    # a training run that reads it
    t1 = time.perf_counter()
    npz, ck = os.path.join(tmp, "h36m.npz"), os.path.join(tmp, "h36m_ck")
    write_h36m_npz(npz, seed)
    rc, h36m_out = _run_entry(train_h36m_ae, ["--npz", npz, "--checkpoint-dir", ck,
                                              "--epochs", str(H36M_EPOCHS), "--batch-size",
                                              "32", "--device", str(dev), "--seed", str(seed)])
    check(rc == 0 and f"epoch {H36M_EPOCHS}:" in h36m_out and "saved" in h36m_out,
          f"train_h36m_ae: {h36m_out[-400:]}")
    evalnet = os.path.join(tmp, "evalnet.npz")
    export(ck, evalnet)
    (_, best), out = _run_entry(run_ted, _run_argv(
        ted, "seq2seq", os.path.join(tmp, "evalnet_run"), 1, 0, seed, dev, "--eval-net",
        evalnet))
    check("[VAL] loss:" in out and "UNTRAINED" not in out and "RANDOMLY" not in out
          and math.isfinite(best), f"run_ted --eval-net: not a trained feature net:\n"
                                   f"{out[-600:]}")
    print(f"hierarchy: train_h36m_ae {H36M_EPOCHS} epochs on a fabricated positions_3d npz "
          f"(" + "; ".join(line.strip() for line in h36m_out.splitlines()
                           if line.startswith("epoch "))
          + f"), export_eval_net, then run_ted --model seq2seq --eval-net <export>: a "
          f"trained feature net, FGD {best:.6g}; {time.perf_counter() - t1:.1f} s")
    print(f"hierarchy: phase 27 in {time.perf_counter() - t0:.1f} s on {smi}")
    return paths


# the serving export (phase 28): four artifacts of the full-width TED
# generator, (GRU route, attention route, batch); each is loaded and run in
# a fresh process that imports hop_tpu_torch.infer alone
EXPORTS = (("fused", "plain", 1), ("fused", "plain", 256), ("stack", "fused", 1),
           ("stack", "block", 1))
EXPORT_TOL = 1e-6        # loaded program vs the eager forward (same kernels)
EXPORT_OPS = {"plain": (), "fused": ("fused_attention_fwd",),
              "block": ("block_attention_fwd",)}
EXPORT_EPOCHS = 2        # the run_ted --tensorboard-dir run of phase 28
CLIP_SECONDS = 20.0

# run in a fresh python3: argv[1] a JSON list of {"name", "clip"}, argv[2] the
# directory of the artifacts and their inputs, argv[3] the parent's device
# and cuDNN settings. Prints one JSON line per artifact.
LOAD_SCRIPT = r"""
import json, os, statistics, sys, time
import torch
settings = json.loads(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
torch.backends.cudnn.deterministic = settings["deterministic"]
torch.backends.cudnn.benchmark = settings["benchmark"]
from hop_tpu_torch import infer
COUNTERS = {"K1": ("reprogramming_attention", "launches"), "K2": ("gru_fused", "launches"),
            "K3_lean": ("gru_stack", "lean_launches"), "K4": ("attention", "launches"),
            "K5": ("block_attention", "launches")}
def counts():
    return {k: getattr(sys.modules["hop_tpu_torch.ops." + m], a) for k, (m, a) in COUNTERS.items()}
def reset():
    for m, a in COUNTERS.values():
        setattr(sys.modules["hop_tpu_torch.ops." + m], a, 0)
dev = settings["device"]
def ms(fn, reps=10):
    fn(); fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)
class Lang:
    def __init__(self, index):
        self.index = index
    def get_word_index(self, w):
        return self.index[w]
tmp = sys.argv[2]
for item in json.loads(sys.argv[1]):
    name = item["name"]
    t0 = time.perf_counter()
    blob = open(os.path.join(tmp, name + ".pt2"), "rb").read()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd = infer.load_exported(blob)
    load_s = time.perf_counter() - t0
    del blob
    models = sorted(m for m in sys.modules if m.startswith("hop_tpu_torch.models"))
    io_ = torch.load(os.path.join(tmp, name + "_io.pt"), map_location=dev)
    reset()
    out = fwd(*io_["inputs"])
    if dev == "cuda":
        torch.cuda.synchronize()
    launched = counts()
    res = {"name": name, "load_s": load_s, "read_s": read_s, "models": models,
           "launches": launched, "max_abs_diff": (out - io_["eager"]).abs().max().item(),
           "shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
           "targets": sorted(t for t in fwd.call_targets() if "hop_tpu_torch" in t),
           "device": str(fwd.device)}
    if io_["inputs"][0].shape[0] > 1 and dev == "cuda":
        res["ms"] = ms(lambda: fwd(*io_["inputs"]))
    if item.get("clip"):
        c = torch.load(os.path.join(tmp, "clip.pt"), weights_only=False)
        import numpy as np
        clip_s = []
        for _ in range(3):     # the first pays the window shapes' first launches
            g = torch.Generator(device=dev).manual_seed(c["seed"])
            t0 = time.perf_counter()
            got = infer.generate_long_form(c["cfg"], infer.make_exported_forward(fwd),
                                           c["audio"], c["words"], c["seed_vec"],
                                           Lang(c["index"]), c["vid"], generator=g,
                                           device=dev)
            clip_s.append(time.perf_counter() - t0)
        res["clip_s"] = clip_s
        res["clip_diff"] = float(np.abs(got - c["eager"]).max())
        res["clip_frames"] = int(got.shape[0])
    print("LOADED " + json.dumps(res), flush=True)
    del fwd, io_, out
    torch.cuda.empty_cache()
"""


def export_rejects(res: dict, cfg) -> list:
    """What disagrees in a loaded artifact's report `res` (LOAD_SCRIPT's line)
    with an export of `cfg`'s routes: a model module imported, a result past
    EXPORT_TOL, launches other than a forward's, a registered op missing from
    the graph."""
    want = {k: v for k, v in forward_launches(cfg).items()
            if k in ("K1", "K2", "K3_lean", "K4", "K5")}
    ops = ["reprogramming_attention_fwd",
           "gru_stack_fwd" if cfg.hop.gru_kernel == "stack" else "gru_fused_layer_fwd",
           *EXPORT_OPS[cfg.llm.attention]]
    bad = []
    if res["models"]:
        bad.append(f"model modules imported: {res['models']}")
    if not (res["finite"] and res["max_abs_diff"] <= EXPORT_TOL):
        bad.append(f"max_abs_diff {res['max_abs_diff']} > {EXPORT_TOL} (finite {res['finite']})")
    if res["launches"] != want:
        bad.append(f"launches {res['launches']}, want {want}")
    missing = [op for op in ops if f"hop_tpu_torch.{op}.default" not in res["targets"]]
    if missing:
        bad.append(f"graph lacks {missing} (has {res['targets']})")
    if res.get("clip_diff", 0.0) > EXPORT_TOL:
        bad.append(f"clip differs by {res['clip_diff']}")
    return bad


def read_events(path: str) -> list:
    """(tag, step, value) of every scalar in a TensorBoard event file:
    TFRecords (u64 length, u32 CRC, data, u32 CRC) of Event protobufs."""
    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = _uvarint(buf, i)
            number, wire = key >> 3, key & 7
            if wire == 0:
                value, i = _uvarint(buf, i)
            elif wire == 1:
                value, i = buf[i:i + 8], i + 8
            elif wire == 5:
                value, i = buf[i:i + 4], i + 4
            else:
                n, i = _uvarint(buf, i)
                value, i = buf[i:i + n], i + n
            yield number, value
    rows = []
    data = open(path, "rb").read()
    i = 0
    while i < len(data):
        (n,) = struct.unpack_from("<Q", data, i)
        event = data[i + 12:i + 12 + n]
        i += 12 + n + 4
        step, summary = 0, None
        for number, value in fields(event):
            if number == 2:
                step = value - (1 << 64) if value >= 1 << 63 else value
            elif number == 5:
                summary = value
        for number, value in fields(summary or b""):
            if number == 1:
                f = dict(fields(value))
                rows.append((f[1].decode(), step, struct.unpack("<f", f[2])[0]))
    return rows


def _uvarint(buf: bytes, i: int) -> tuple:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return value, i


def phase_export(dev, seed):
    """Returns {path name: launches} of each loaded artifact's forward."""
    import numpy as np
    import torch
    from hop_tpu_torch import infer
    from hop_tpu_torch.cli import export_model, test_checkpoint
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import WordIndex, make_clip
    from hop_tpu_torch.models import reprogramming
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.ops import reprogramming_attention as K1
    smi = _smi()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hop_export_")
    try:
        model = build_hop_model(ted_route_config(), N_SPEAKERS, seed, device=dev)
        sizes, export_s, eager_ms = {}, {}, None
        alen = infer.serving_inputs(ted_route_config(), 1, "meta")[0].shape[1]

        def save(name, cfg, B):
            t0 = time.perf_counter()
            blob = infer.export_forward(model, cfg, B, device=dev)
            export_s[name] = time.perf_counter() - t0
            sizes[name] = len(blob) / 1e6
            with open(os.path.join(tmp, name + ".pt2"), "wb") as f:
                f.write(blob)

        for gru, attention, B in EXPORTS:
            name = f"{gru}_{attention}_bs{B}"
            cfg = ted_route_config(gru, attention=attention)
            model.gru.kernel = gru
            model.llm_model.set_attention(attention)
            batch = serving_batch(cfg, B, seed, dev)
            inputs = (batch["in_audio"][:, :alen].contiguous(), batch["x_enc"],
                      batch["text"], batch["pre_seq"], batch["vid_indices"], batch["eps"])
            with torch.inference_mode():
                eager = model(*inputs[:5], eps=inputs[5])[0]
            torch.save({"inputs": inputs, "eager": eager}, os.path.join(tmp, name + "_io.pt"))
            if B > 1:
                with torch.inference_mode():
                    eager_ms = cuda_ms(lambda: model(*inputs[:5], eps=inputs[5]),
                                       reps=10, warmup=2)
            save(name, cfg, B)
            if (gru, attention, B) == EXPORTS[0]:
                # the planted fault: K1 swapped for its plain version
                plain = reprogramming.reprogramming_attention
                reprogramming.reprogramming_attention = K1.plain_reprogramming_attention
                try:
                    save("planted", cfg, B)
                finally:
                    reprogramming.reprogramming_attention = plain
                shutil.copy(os.path.join(tmp, name + "_io.pt"),
                            os.path.join(tmp, "planted_io.pt"))
        model.gru.kernel = "fused"
        model.llm_model.set_attention("plain")

        # a 20 s clip at bs 1, eager, then through the loaded bs-1 artifact
        cfg = ted_route_config()
        clip = make_clip(cfg, seconds=CLIP_SECONDS, seed=1)
        lang = WordIndex(clip.words)
        vid = 3
        clip_eager_s = []
        for _ in range(3):     # the first pays the window shapes' first launches
            g = torch.Generator(device=dev).manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager_clip = infer.generate_long_form(
                cfg, infer.make_forward(model), clip.audio, clip.words, clip.seed_dir_vec,
                lang, vid, generator=g, device=dev)
            clip_eager_s.append(time.perf_counter() - t0)
        torch.save({"cfg": cfg, "audio": clip.audio, "words": clip.words,
                    "seed_vec": clip.seed_dir_vec, "vid": vid, "seed": seed,
                    "index": {w[0]: lang.get_word_index(w[0]) for w in clip.words},
                    "eager": eager_clip}, os.path.join(tmp, "clip.pt"))

        # load and run each artifact in a fresh process
        items = [{"name": f"{g}_{a}_bs{B}", "clip": (g, a, B) == EXPORTS[0]}
                 for g, a, B in EXPORTS] + [{"name": "planted"}]
        settings = {"device": dev.type, "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                    "deterministic": torch.backends.cudnn.deterministic,
                    "benchmark": torch.backends.cudnn.benchmark}
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": root}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", LOAD_SCRIPT, json.dumps(items), tmp,
                               json.dumps(settings)], cwd=root, env=env,
                              capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"export: the loading process failed:\n{proc.stderr[-4000:]}")
        loaded = {r["name"]: r for r in (json.loads(line[len("LOADED "):])
                                         for line in proc.stdout.splitlines()
                                         if line.startswith("LOADED "))}
        check(len(loaded) == len(items), f"export: {len(loaded)} artifacts reported")
        paths = {}
        for g, a, B in EXPORTS:
            name = f"{g}_{a}_bs{B}"
            res = loaded[name]
            bad = export_rejects(res, ted_route_config(g, attention=a))
            check(not bad, f"export {name}: " + "; ".join(bad))
            check(res["shape"] == [B, cfg.data.n_poses, cfg.data.pose_dim],
                  f"export {name}: shape {res['shape']}")
            paths[f"export_{name}"] = {**ZERO_COUNTS, **res["launches"]}
        planted = export_rejects(loaded["planted"], ted_route_config())
        check(bool(planted), "export: the artifact with K1 swapped for its plain "
                             "version passed the checks")
        res1 = loaded[items[0]["name"]]
        res256 = loaded["fused_plain_bs256"]
        print(f"export [TED full width, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
              f"params; torch.export, weights inside]: "
              + "; ".join(f"{r['name']} {sizes[r['name']]:.1f} MB, export "
                          f"{export_s[r['name']]:.2f} s, load {r['load_s']:.2f} s (read "
                          f"{r['read_s']:.2f} s), max_abs_diff {r['max_abs_diff']:.3e}, "
                          f"launches {_nonzero(r['launches'])}"
                          for r in (loaded[f'{g}_{a}_bs{B}'] for g, a, B in EXPORTS))
              + f"; each loaded in a fresh process ({sub_s:.1f} s for all, "
              f"{len(items)} artifacts) with no hop_tpu_torch.models module, its graph "
              f"calling the registered ops (tol {EXPORT_TOL:g}); the planted artifact "
              f"(K1 swapped for its plain version) rejected: {'; '.join(planted)}")
        print(f"export times: bs-256 forward eager {eager_ms:.3f} ms, loaded "
              f"{fmt_ms(res256.get('ms'))} ms (CUDA events, median of 10, each in its own "
              f"process); {CLIP_SECONDS:.0f} s clip at bs 1 ({res1['clip_frames']} frames) "
              f"s per clip eager {', '.join(f'{t:.3f}' for t in clip_eager_s)}, loaded "
              f"{', '.join(f'{t:.3f}' for t in res1['clip_s'])} (host clock), clip "
              f"max_abs_diff {res1['clip_diff']:.3e}; on {smi}")
        del model
        torch.cuda.empty_cache()

        # a training run with --tensorboard-dir, then cli.export_model on it
        ck = os.path.join(tmp, "run")
        tb = os.path.join(tmp, "tb")
        tempdir, tempfile.tempdir = tempfile.tempdir, tmp
        try:
            t0 = time.perf_counter()
            _run_ted((*RUN_ARGS, "--seed", str(seed), "--epochs", str(EXPORT_EPOCHS),
                      "--checkpoint-dir", ck, "--metrics", os.path.join(ck, "metrics.jsonl"),
                      "--tensorboard-dir", tb))
            run_s = time.perf_counter() - t0
        finally:
            tempfile.tempdir = tempdir
        rows = [json.loads(line) for line in open(os.path.join(ck, "metrics.jsonl"))]
        events = [f for f in os.listdir(tb) if f.startswith("events.out.tfevents.")]
        check(len(events) == 1, f"tensorboard: event files {events}")
        got = read_events(os.path.join(tb, events[0]))
        want = [(r["name"], r["step"], float(np.float32(r["value"]))) for r in rows]
        check(rows and got == want, f"tensorboard: {got} vs metrics.jsonl {want}")
        print(f"tensorboard: run_ted --tensorboard-dir, {EXPORT_EPOCHS} epochs at full TED "
              f"width ({run_s:.1f} s): {len(got)} scalars in "
              f"{os.path.getsize(os.path.join(tb, events[0]))} bytes, each row of "
              f"metrics.jsonl with its step and its value in f32")

        out = os.path.join(tmp, "cli.pt2")
        t0 = time.perf_counter()
        _, log = _run_entry(export_model, ["--checkpoint-dir", ck, "--out", out,
                                           "--params-out", os.path.join(tmp, "p.npz")])
        cli_s = time.perf_counter() - t0
        fwd = infer.load_exported(open(out, "rb").read())
        io_ = torch.load(os.path.join(tmp, items[0]["name"] + "_io.pt"), map_location=dev)
        inputs = list(io_["inputs"])
        inputs[4] = torch.zeros_like(inputs[4])     # a speaker of the run's
        _reset_counts()
        y = fwd(*inputs)
        torch.cuda.synchronize()
        check(tuple(y.shape) == (1, cfg.data.n_poses, cfg.data.pose_dim)
              and bool(torch.isfinite(y).all()), f"export_model: output {tuple(y.shape)}")
        check(_launch_counts() == forward_launches(cfg),
              f"export_model's artifact: launches {_launch_counts()}")
        print(f"export_model: python -m hop_tpu_torch.cli.export_model on the run's "
              f"checkpoint in {cli_s:.1f} s ({log.strip().splitlines()[-2]}); its artifact "
              f"runs, launches {_nonzero(_launch_counts())}")
        del fwd, io_, inputs, y

        # --render-video on a 20 s clip
        model = build_hop_model(cfg, N_SPEAKERS, seed, device=dev)
        render_dir = os.path.join(tmp, "render")
        demo = types.SimpleNamespace(main=lambda argv: test_checkpoint.main(argv, model=model))
        t0 = time.perf_counter()
        _, log = _run_entry(demo, ["--device", str(dev), "--seed", "1",
                                   "--clip-seconds", str(CLIP_SECONDS),
                                   "--render-video", "--out", render_dir])
        render_s = time.perf_counter() - t0
        files = sorted(os.listdir(render_dir))
        video = [f for f in files if f.startswith("demo_0.") and f[-4:] in (".gif", ".mp4")]
        check(len(video) == 1, f"render: files {files}")
        writer = "ffmpeg (mp4)" if video[0].endswith(".mp4") else "GIF89a encoder (no ffmpeg)"
        check(writer.startswith("ffmpeg") or "demo_0.wav" in files, f"render: files {files}")
        frames = int(log.split("generated ")[1].split()[0])
        check(frames == res1["clip_frames"], f"render: {frames} frames")
        print(f"render: test_checkpoint --render-video on a {CLIP_SECONDS:.0f} s clip "
              f"({frames} frames) in {render_s:.1f} s with generation "
              f"({log.split('rendered video in ')[1].split('s')[0]} s rendering), writer "
              f"{writer}, {video[0]} {os.path.getsize(os.path.join(render_dir, video[0]))} "
              f"bytes, files {files}")
        del model
        print(f"export: phase 28 in {time.perf_counter() - t_phase:.1f} s on {smi}")
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 29: the parallel path (ROADMAP M15) ------------------------------
# Two fused GAN steps of the full-width TED model at global bs 256 on 2 ranks
# (gloo on one card, or NCCL on two) against the same steps in one process:
# the same global batch and draws, dropout off and the backbone's products
# in f32, so that what is left is the order of f32 sums (each rank's 128 rows,
# the batch statistics and gradients summed over the ranks). Limits on the
# losses of both steps (relative), on each gradient tensor of the first step
# (the second's are taken where the parameters already differ; relative to
# its net's largest gradient: a bias that a BatchNorm nearly cancels keeps
# a gradient of round-off size, which no per-tensor limit resolves) and on
# the parameters after two steps, in units of the learning rate, where the
# first step's gradient is at least PAR_RESOLVED of its net's largest. An
# element whose gradient is round-off of zero moves by a round-off-signed lr
# a step (Adam divides by the gradient's own size), so two sound runs may
# differ there by 2 lr a step, and the second step's gradients differ with
# the parameters they are taken at. The limits sit between the readings and
# a planted fault, the head's GRU output x 1.001 on every rank, which each
# of them must catch (PERF.md §6).
PAR_STEPS = 2
PAR_LOSS_TOL = 1e-4
PAR_GRAD_TOL = 1e-4
PAR_RESOLVED = 1e-2
PAR_PARAM_LR = 0.6
PAR_TIMEOUT = 900
PAR_FAULT = 1.001
# the kernels at a rank's shapes: the backbone's heads at model = 2 and 4,
# K1 and K2 at a rank's rows at data = 2 and 4
PAR_HEADS = (6, 3)
PAR_ROWS = (128, 64)


def _attention_inputs_h(dev, seed, B, H):
    import torch
    _, T, _, D = ATTN_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed + B + 100 * H)
    return [torch.randn(B, T, H, D, device=dev, generator=g).to(torch.bfloat16)
            for _ in range(4)]


def _sdpa_times(q, k, v, do):
    """F.scaled_dot_product_attention's forward and backward-alone ms on
    (B, T, H, D) operands (a yardstick, used nowhere in the port)."""
    import torch
    import torch.nn.functional as F

    def sdpa(q=q, k=k, v=v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2)).transpose(1, 2)

    def graph():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return leaves, sdpa(*leaves)

    def bwd(made):
        leaves, out = made
        torch.autograd.grad(out, leaves, do)
    return cuda_ms(sdpa), cuda_ms(bwd, setup=graph)


def phase_parallel_kernels(dev, seed):
    """K4 and K5 at the heads a rank of a model group holds, K1 and K2 at a
    rank's rows of the bs-256 batch: forward and backward against their plain
    versions, ms, plain ms, bound and the library call's ms."""
    import torch
    import torch.nn.functional as F
    from hop_tpu_torch.ops import attention as K4
    from hop_tpu_torch.ops import block_attention as K5
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import reprogramming_attention as K1
    _, T, _, D = ATTN_SHAPE
    scale, drop_seed = D ** -0.5, 4321
    res = {"K4": {}, "K5": {}, "K1": {}, "K2": {}}
    mods = {"K4": (K4.fused_attention_fwd, K4.fused_attention_bwd,
                   K4.plain_fused_attention, K4.plain_fused_attention_bwd, K4_TOL,
                   K4_BWD_REL_TOL),
            "K5": (K5.block_attention_fwd, K5.block_attention_bwd,
                   K5.plain_block_attention, K5.plain_block_attention_bwd, K5_TOL,
                   BWD_REL_TOL)}
    B = ATTN_SHAPE[0]
    for H in PAR_HEADS:
        q, k, v, do = _attention_inputs_h(dev, seed, B, H)
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        lib_fwd, lib_bwd = _sdpa_times(q, k, v, do)
        flops = 2 * 2.0 * B * H * T * T * D
        for name, (fwd, bwd, plain, plain_bwd, tol, bwd_tol) in mods.items():
            r = {"max_abs_err": 0.0, "bwd_rel": 0.0}
            for rate in (0.0, 0.1):
                args = (scale, rate, drop_seed)
                got, want = fwd(q, k, v, *args), plain(qf, kf, vf, *args)
                err = (got.float() - want).abs().max().item()
                check(err <= tol, f"{name} at H={H}, rate {rate}: {err} > {tol}")
                r["max_abs_err"] = max(r["max_abs_err"], err)
                for gname, a, c in zip(("dq", "dk", "dv"), bwd(q, k, v, do, *args),
                                       plain_bwd(qf, kf, vf, dof, *args)):
                    e_rel = rel_err(a.float(), c)[1]
                    check(e_rel <= bwd_tol, f"{name} bwd at H={H}, rate {rate} {gname}: "
                                            f"{e_rel} > {bwd_tol} relative")
                    r["bwd_rel"] = max(r["bwd_rel"], e_rel)
            args = (scale, 0.1, drop_seed)
            r.update(ms=cuda_ms(lambda: fwd(q, k, v, scale)),
                     plain_ms=cuda_ms(lambda: plain(q, k, v, scale), reps=10),
                     bwd_ms=cuda_ms(lambda: bwd(q, k, v, do, *args)),
                     bwd_plain_ms=cuda_ms(lambda: plain_bwd(q, k, v, do, *args), reps=10),
                     library_ms=lib_fwd, library_bwd_ms=lib_bwd,
                     **bound((q, k, v), fwd(q, k, v, scale), flops, BF16_FLOPS))
            bb = bound((q, k, v, do), bwd(q, k, v, do, *args), 2.5 * flops, BF16_FLOPS)
            r.update(bwd_bound_ms=bb["bound_ms"], bwd_bound_by=bb["bound_by"])
            res[name][f"H{H}"] = r
            print(f"parallel kernels: {name} at (B={B}, T={T}, H={H}, D={D}) (the backbone's "
                  f"heads on a rank of a model group of {12 // H}): forward max_abs_err "
                  f"{r['max_abs_err']:.3e} (tol {tol:g}), backward worst rel "
                  f"{r['bwd_rel']:.2e} (tol {bwd_tol:g}), rate 0 and 0.1; forward "
                  f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms vs SDPA {lib_fwd:.3f} "
                  f"ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}); backward "
                  f"{r['bwd_ms']:.3f} ms (rate 0.1) vs plain {r['bwd_plain_ms']:.3f} ms vs "
                  f"SDPA's {lib_bwd:.3f} ms (rate 0; bound {r['bwd_bound_ms']:.4f} ms by "
                  f"{r['bwd_bound_by']})")
    E = K1.HEAD_DIM
    for B in PAR_ROWS:
        L, H, S = 34, 8, 1500
        q, k, v, do = _k1_bwd_inputs(dev, seed + 3, B, L, H, E, S)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        sc = E ** -0.5
        r = {"max_abs_err": 0.0, "bwd_rel": 0.0}
        for rate in (0.0, 0.1):
            args = (sc, rate, 1234)
            out, lse = K1.reprogramming_attention_fwd(q, k, v, *args, with_lse=True)
            want, want_lse = K1.plain_reprogramming_attention(q, k, v, *args, with_lse=True)
            err = max((out - want).abs().max().item(), (lse - want_lse).abs().max().item())
            check(err <= K1_TOL, f"K1 at B={B}, rate {rate}: {err} > {K1_TOL}")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            for gname, a, c in zip(("dq", "dk", "dv"),
                                   K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *args),
                                   K1.plain_reprogramming_attention_bwd(q, k, v, want, want_lse,
                                                                        do, *args)):
                e_rel = rel_err(a, c)[1]
                check(e_rel <= BWD_REL_TOL, f"K1 bwd at B={B}, rate {rate} {gname}: {e_rel}")
                r["bwd_rel"] = max(r["bwd_rel"], e_rel)
        out, lse = K1.reprogramming_attention_fwd(q, k, v, sc, 0.1, 1234, with_lse=True)

        def sdpa():
            qf = qb.permute(2, 0, 1, 3).reshape(1, H, B * L, E)
            return F.scaled_dot_product_attention(qf, kb[None], vb[None], scale=sc)

        def graph():
            leaves = [t.clone().requires_grad_() for t in (qb, kb, vb)]
            qf = leaves[0].permute(2, 0, 1, 3).reshape(1, H, B * L, E)
            return leaves, F.scaled_dot_product_attention(qf, leaves[1][None],
                                                          leaves[2][None], scale=sc)
        dof = do.to(torch.bfloat16).permute(2, 0, 1, 3).reshape(1, H, B * L, E)
        r.update(ms=cuda_ms(lambda: K1.reprogramming_attention(qb, kb, vb, sc)),
                 plain_ms=cuda_ms(lambda: K1.plain_reprogramming_attention(q, k, v, sc), reps=5),
                 bwd_ms=cuda_ms(lambda: K1.reprogramming_attention_bwd(
                     qb, kb, vb, out, lse, do, sc, 0.1, 1234), reps=10),
                 bwd_plain_ms=cuda_ms(lambda: K1.plain_reprogramming_attention_bwd(
                     q, k, v, out, lse, do, sc, 0.1, 1234), reps=5),
                 library_ms=cuda_ms(sdpa),
                 library_bwd_ms=cuda_ms(lambda made: torch.autograd.grad(made[1], made[0], dof),
                                        setup=graph),
                 **bound((qb, kb, vb), out, 2 * 2.0 * B * L * H * S * E, BF16_FLOPS))
        bb = bound((q, k, v, out, lse, do), K1.reprogramming_attention_bwd(
            qb, kb, vb, out, lse, do, sc, 0.1, 1234), 5 * 2.0 * B * L * H * S * E, BF16_FLOPS)
        r.update(bwd_bound_ms=bb["bound_ms"], bwd_bound_by=bb["bound_by"])
        res["K1"][f"B{B}"] = r
        print(f"parallel kernels: K1 at (B={B}, L={L}, H={H}, S={S}) (a rank's rows at "
              f"data = {256 // B}): forward max_abs_err {r['max_abs_err']:.3e} (tol "
              f"{K1_TOL:g}), backward worst rel {r['bwd_rel']:.2e} (tol {BWD_REL_TOL:g}); "
              f"forward {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} vs SDPA "
              f"{r['library_ms']:.3f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}); "
              f"backward {r['bwd_ms']:.3f} ms vs plain {r['bwd_plain_ms']:.3f} vs SDPA's "
              f"{r['library_bwd_ms']:.3f} ms (bound {r['bwd_bound_ms']:.4f} by "
              f"{r['bwd_bound_by']})")

        T2, I, H2, D2 = 34, 992, 350, 2
        args = _k2_inputs(dev, seed, T2, B, I, H2, D2)
        fwd = K2.gru_fused_layer_fwd(*args, with_residuals=True)
        err = max((a - b).abs().max().item() for a, b in
                  zip(fwd, K2.plain_gru_fused_layer(*args, with_residuals=True)))
        check(err <= K2_TOL, f"K2 at B={B}: {err} > {K2_TOL}")
        h_seq, rr, z, n, hnb = fwd
        dout = torch.randn(D2, T2, B, H2, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed + B))
        bwd_args = (dout, args[0], rr, z, n, hnb, K2.hprev_of(h_seq, args[5]), args[1], args[3])
        got = K2.gru_fused_layer_bwd(*bwd_args)
        bwd_rel = max(rel_err(a, c)[1] for a, c in
                      zip(got, K2.plain_gru_fused_layer_bwd(*bwd_args)))
        check(bwd_rel <= BWD_REL_TOL, f"K2 bwd at B={B}: {bwd_rel} > {BWD_REL_TOL}")
        lean = K2.gru_fused_layer(*args)
        yard = gru_layer_yardstick(dev, seed, T2, B, I, H2)
        r2 = {"max_abs_err": err, "bwd_rel": bwd_rel,
              "ms": cuda_ms(lambda: K2.gru_fused_layer(*args)),
              "plain_ms": cuda_ms(lambda: K2.plain_gru_fused_layer(*args), reps=5),
              "bwd_ms": cuda_ms(lambda: K2.gru_fused_layer_bwd(*bwd_args), reps=10),
              "bwd_plain_ms": cuda_ms(lambda: K2.plain_gru_fused_layer_bwd(*bwd_args), reps=5),
              "library_ms": yard["cudnn"][0], "library_bwd_ms": yard["cudnn_bwd"],
              **bound(args, lean, 2.0 * T2 * B * D2 * 3 * H2 * (I + H2), F32_FLOPS)}
        bb = bound(bwd_args, got, 2.0 * T2 * B * D2 * 3 * H2 * (2 * H2 + 2 * I), F32_FLOPS)
        r2.update(bwd_bound_ms=bb["bound_ms"], bwd_bound_by=bb["bound_by"])
        res["K2"][f"B{B}"] = r2
        print(f"parallel kernels: K2 at (T={T2}, B={B}, I={I}, H={H2}, D={D2}): forward "
              f"max_abs_err {err:.3e} (tol {K2_TOL:g}), backward worst rel {bwd_rel:.2e}; "
              f"lean forward {r2['ms']:.3f} ms vs plain {r2['plain_ms']:.3f} vs cuDNN "
              f"{r2['library_ms']:.3f} ms (bound {r2['bound_ms']:.4f} by {r2['bound_by']}); "
              f"backward {r2['bwd_ms']:.3f} ms vs plain {r2['bwd_plain_ms']:.3f} vs cuDNN's "
              f"{r2['library_bwd_ms']:.3f} ms (bound {r2['bwd_bound_ms']:.4f} by "
              f"{r2['bwd_bound_by']})")
    return res


def _par_nets(model_cpu, disc_cpu, dev, exact: bool):
    """Copies of the nets on `dev`; `exact`: dropout off and the backbone's
    products in f32 (the world-2 comparison's setting)."""
    model, disc = copy.deepcopy(model_cpu).to(dev), copy.deepcopy(disc_cpu).to(dev)
    if exact:
        model.llm_model.dropout_rate = 0.0
        model.reprogramming_layer.attention_dropout = 0.0
        disc.gru.dropout = 0.0
        for layer in model.llm_model.encoder.layer:
            layer.cfg = dataclasses.replace(layer.cfg, compute_bf16=False)
    return model, disc


def _par_steps(cfg, model, disc, batch, mesh, seed, fault: bool = False):
    """PAR_STEPS fused GAN steps (the steady variant) from the step
    generator seeded `seed`, on a rank of `mesh` (None: one process).
    Returns (state, gan, generator, [metrics a step], launches, the first
    step's gradients on the host)."""
    import torch
    from hop_tpu_torch.parallel import attach_batch_group
    from hop_tpu_torch.train.llm import make_hop_train_steps
    attach_batch_group(model, mesh)
    attach_batch_group(disc, mesh)
    if fault:
        model.gru.register_forward_hook(lambda m, i, o: (o[0] * PAR_FAULT, *o[1:]))
    _, gan, init_state = make_hop_train_steps(cfg, model, disc, mesh)
    state, g, metrics = init_state(), torch.Generator().manual_seed(seed), []
    _reset_counts()
    grads = None
    for _ in range(PAR_STEPS):
        state, m = gan.for_epoch(1)(state, batch, g)
        metrics.append({k: v.item() for k, v in m.items()})
        grads = grads or {k: p.grad.cpu() for k, p in _par_trainable(model, disc).items()
                          if p.grad is not None}
    torch.cuda.synchronize()
    return state, gan, g, metrics, _launch_counts(), grads


def _par_trainable(model, disc) -> dict:
    return {**_trainable(model), **{"D." + k: p for k, p in _trainable(disc).items()}}


def _par_snapshot(model, disc, grads) -> dict:
    """The trainable parameters (on the host) with the first step's
    gradients."""
    return {k: (p.detach().cpu(), grads[k]) for k, p in _par_trainable(model, disc).items()
            if k in grads}


PAR_KEYS = ("loss", "KLD", "DIV_REG", "gen", "dis")


def _net_of(name: str) -> str:
    """The net a parameter of `_par_trainable` belongs to."""
    return "D" if name.startswith("D.") else "G"


def _par_errors(metrics, snap, ref, cfg, keys=PAR_KEYS, group=_net_of) -> dict:
    """A run against the one-process reference: the losses' (`keys`) largest
    relative error (`loss`, at `loss_at`: key and step), the worst gradient
    tensor's relative to the largest gradient of its `group` (by default its
    net), the parameters' largest difference in units of each net's learning
    rate where the reference's first-step gradient is resolved (at least
    PAR_RESOLVED of its group's largest: `param_lr`) and everywhere
    (`param_all`); `by_group`: each group's worst gradient and parameter
    readings."""
    losses = {(k, i): abs(m[k] - r[k]) / max(abs(r[k]), 1e-12)
              for i, (m, r) in enumerate(zip(metrics, ref["metrics"])) for k in keys}
    loss_at = max(losses, key=losses.get)
    grads, params, params_all, by_group = {}, 0.0, 0.0, {}
    lr = cfg.train.learning_rate
    for name in sorted({group(k) for k in ref["snap"]}):
        mine = {k: v for k, v in ref["snap"].items() if group(k) == name}
        top = max(g.abs().max().item() for _, g in mine.values())
        worst_param = 0.0
        for k, (p, g) in mine.items():
            unit = lr * (cfg.train.dis_lr_scale if k.startswith("D.") else 1.0)
            grads[k] = (snap[k][1] - g).abs().max().item() / top
            diff = (snap[k][0] - p).abs() / unit
            params_all = max(params_all, diff.max().item())
            resolved = g.abs() >= PAR_RESOLVED * top
            if resolved.any():
                worst_param = max(worst_param, diff[resolved].max().item())
        params = max(params, worst_param)
        by_group[name] = (max(grads[k] for k in mine), worst_param)
    worst = max(grads, key=grads.get)
    return {"loss": losses[loss_at], "loss_at": loss_at, "grad": grads[worst],
            "grad_at": worst, "param_lr": params, "param_all": params_all,
            "by_group": by_group}


def _rank_dp(mesh, spec, dev) -> dict:
    """World 2 over the batch: the exact steps with ZeRO, without, and with the
    planted fault, against the reference; then phase 9's steps timed."""
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import make_train_batch
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.parallel import batch_rows
    from hop_tpu_torch.utils.checkpoint import differing_entries
    seed, cfg = spec["seed"], ted_route_config()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed, "cpu")
    disc_cpu = build_discriminator(cfg, seed + 1, "cpu")
    batch = batch_rows(make_train_batch(cfg, cfg.train.batch_size, seed, N_SPEAKERS, dev), mesh)
    ref = torch.load(spec["ref"], weights_only=False)
    out, states, clock = {}, {}, {"set up": time.perf_counter() - spec["t0"]}
    for name, zero, fault in (("zero", True, False), ("no_zero", False, False),
                              ("fault", True, True)):
        t0 = time.perf_counter()
        mesh.zero2 = zero
        model, disc = _par_nets(model_cpu, disc_cpu, dev, exact=True)
        state, _, _, metrics, launches, grads = _par_steps(
            cfg, model, disc, batch, mesh, seed, fault)
        out[name] = _par_errors(metrics, _par_snapshot(model, disc, grads), ref, cfg)
        if name != "fault":
            states[name] = state.state_dict()
        out[name]["launches"] = launches
        clock[name] = time.perf_counter() - t0
        del model, disc, state
    out["zero_vs_no_zero"] = differing_entries(states["zero"], states["no_zero"])
    del states
    torch.cuda.empty_cache()
    # phase 9's steps (bf16 backbone, dropout on), ZeRO on, timed on this rank
    mesh.zero2 = True
    model, disc = _par_nets(model_cpu, disc_cpu, dev, exact=False)
    state, gan, g, _, _, _ = _par_steps(cfg, model, disc, batch, mesh, seed)
    out["zero_sharded"] = sum(ax is not None for ax in state.gen_opt.axes)
    t0 = time.perf_counter()
    # the card to these ranks alone: the training runs that share it with the
    # comparisons above have ended
    while not os.path.exists(spec["gate"]):
        check(time.perf_counter() - t0 < PAR_TIMEOUT, "phase 29: the gate never opened")
        time.sleep(0.1)
    clock["waiting"], t0 = time.perf_counter() - t0, time.perf_counter()

    def step():
        nonlocal state
        state, _ = gan(state, batch, g)
    ms = cuda_ms(step, reps=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    busy, device_ms, top = _busy_share(step, 2, ms)
    out["timing"] = (ms, device_ms, busy, top, torch.cuda.max_memory_allocated() / 2 ** 30)
    clock["timing"] = time.perf_counter() - t0
    out["local_batch"], out["clock"] = int(batch["in_audio"].shape[0]), clock
    return out


def _rank_tp(mesh, spec, dev) -> dict:
    """Model = 2 on the LLaMA-7B backbone (phase 24's, 6 layers): the bs-256
    forward and one fused GAN step against model = 1, which the group's first
    rank computes before it shards its copy; each rank's peak memory."""
    import torch
    import torch.distributed as dist
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import make_train_batch
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.parallel import attach_batch_group
    from hop_tpu_torch.parallel.collectives import barrier
    from hop_tpu_torch.train.llm import make_hop_train_steps
    from hop_tpu_torch.models.hop import HOPModel
    seed, cfg = spec["seed"], llama_route_config()
    B = cfg.train.batch_size
    clock, t0 = {}, time.perf_counter()
    # built on the card from the seed (the same weights on both ranks, and for
    # model = 1; 10 s on the host, phase 24)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), \
            torch.device(dev):
        torch.manual_seed(seed)
        model_full = HOPModel(cfg, N_SPEAKERS)
    clock["build"] = time.perf_counter() - t0
    disc_cpu = build_discriminator(cfg, seed + 1, "cpu")
    sbatch = serving_batch(cfg, B, seed, dev)
    tbatch = make_train_batch(cfg, B, seed, N_SPEAKERS, dev)

    def forward(m):
        with torch.inference_mode():
            return m(sbatch["in_audio"], sbatch["x_enc"], sbatch["text"], sbatch["pre_seq"],
                     sbatch["vid_indices"], eps=sbatch["eps"])[0]

    def step(model, m):
        disc = copy.deepcopy(disc_cpu).to(dev)
        attach_batch_group(model, m)
        attach_batch_group(disc, m)
        _, gan, init_state = make_hop_train_steps(cfg, model, disc, m)
        _, metrics = gan(init_state(), tbatch, torch.Generator().manual_seed(seed))
        return ({k: v.item() for k, v in metrics.items()},
                {k: p.grad.cpu() for k, p in _trainable(model).items() if p.grad is not None})
    ref = None
    t0 = time.perf_counter()
    if mesh.model_rank == 0:
        model1 = copy.deepcopy(model_full)
        ref = (forward(model1).cpu(), *step(model1, None))
        del model1
    barrier()
    clock["model = 1"], t0 = time.perf_counter() - t0, time.perf_counter()
    model_full.llm_model.shard_(mesh.model_group, mesh.model_rank, mesh.n_model)
    model = model_full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out2 = forward(model)
    metrics, grads = step(model, mesh)
    torch.cuda.synchronize()
    clock["model = 2"] = time.perf_counter() - t0
    res = {"launches": _launch_counts(), "clock": clock,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "backbone_gib": sum(p.numel() * p.element_size()
                               for p in model.llm_model.parameters()) / 2 ** 30}
    first = out2.clone()
    dist.broadcast(first, src=mesh.model_ranks()[0], group=mesh.model_group)
    res["same_as_rank0"] = bool(torch.equal(first, out2))
    if ref is not None:
        out1, m1, g1 = ref
        res["fwd_err"] = (out2.cpu() - out1).abs().max().item()
        res["loss_err"] = max(abs(metrics[k] - m1[k]) / max(abs(m1[k]), 1e-12)
                              for k in ("loss", "KLD", "DIV_REG", "gen", "dis"))
        top = max(g.abs().max().item() for g in g1.values())
        errs = {k: rel_err(grads[k], g)[1] for k, g in g1.items()
                if g.abs().max().item() >= 1e-5 * top}
        res["grad_at"] = max(errs, key=errs.get)
        res["grad_err"] = errs[res["grad_at"]]
    return res


def rank_main(spec_path: str) -> None:
    """One rank of phase 29's or phase 30's world of 2 (`python3 chip_smoke.py
    --rank <spec>`, launched by phase_parallel or phase_parallel_hierarchy
    through `parallel.local.run_ranks`)."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hop_tpu_torch.parallel.mesh import destroy, init_distributed, make_mesh
    if not torch.cuda.is_available():
        sys.exit("chip_smoke --rank: no CUDA card")
    from hop_tpu_torch.cli.train_main import deterministic_cudnn
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    spec["t0"] = time.perf_counter()
    mesh = init_distributed(spec["device"], data_parallel=2, backend=spec["backend"])
    dev = mesh.device
    deterministic_cudnn(dev)       # ZeRO on and off, two runs, compared bitwise
    out = {"backend": mesh.backend, "device": str(dev)}
    if spec.get("kind") == "hierarchy":
        out["dp"] = _rank_hier(mesh, spec, dev)
    else:
        out["dp"] = _rank_dp(mesh, spec, dev)
        out["tp"] = _rank_tp(make_mesh((1, 1, 2), dev), spec, dev)
    torch.save(out, f"{spec['out']}.{mesh.rank}.pt")
    destroy()


def _par_run_ted(seed, backend, device, tmp, gate: str, flags=("--llm-layers", "2")) -> dict:
    """`run_ted --data-parallel 2` at full TED width with `flags`, as torchrun
    launches it: 2 epochs in one run and 1 epoch then `--resume` to 2 (the
    first two runs side by side), bit for bit. Creates the file `gate` when
    the runs have ended, however they end."""
    try:
        return _par_run_ted_runs(seed, backend, device, tmp, flags)
    finally:
        open(gate, "w").close()


def _par_run_ted_runs(seed, backend, device, tmp, flags) -> dict:
    import concurrent.futures
    import torch
    from hop_tpu_torch.parallel.local import check_ranks, run_ranks
    from hop_tpu_torch.utils.checkpoint import differing_entries, flat_entries
    root = os.path.dirname(os.path.abspath(__file__))

    def run(name, epochs, *extra):
        ck = os.path.join(tmp, name)
        argv = ["-m", "hop_tpu_torch.cli.run_ted", "--device", device, "--dist-backend",
                backend, "--data-parallel", "2", "--synthetic-videos", "1", "--batch-size",
                "16", *flags, "--warmup-epochs", "0", "--seed", str(seed),
                "--epochs", str(epochs),
                "--log-every", "1", "--checkpoint-dir", ck, "--metrics",
                os.path.join(ck, "metrics.jsonl"), *extra]
        t0 = time.perf_counter()
        out = check_ranks(run_ranks(argv, 2, PAR_TIMEOUT, {"PYTHONPATH": root}, threads=4))
        return ck, out, time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        whole, first = pool.submit(run, "A", 2), pool.submit(run, "B", 1)
        (ck_a, out_a, s_a), (_, _, s_b1) = whole.result(), first.result()
    ck_b, out_b, s_b2 = run("B", 2, "--resume")
    check("mesh: data=2 x model=1 (zero2 opt-state sharding)" in out_a,
          "run_ted under 2 ranks did not print its mesh")
    check("resumed from checkpoint epoch 0" in out_b, "the resumed run did not resume")
    a = torch.load(os.path.join(ck_a, "ckpt_1.pt"), weights_only=True)
    b = torch.load(os.path.join(ck_b, "ckpt_1.pt"), weights_only=True)
    diff = differing_entries(a, b)
    check(diff == [], f"run_ted on 2 ranks: 2 epochs vs 1 + --resume differ at {diff[:5]}")
    with open(os.path.join(ck_a, "metrics.jsonl"), "rb") as fa, \
            open(os.path.join(ck_b, "metrics.jsonl"), "rb") as fb:
        check(fa.read() == fb.read(), "run_ted on 2 ranks: the metrics.jsonl files differ")
    return {"seconds": (s_a, s_b1, s_b2), "entries": len(flat_entries(a)),
            "epochs": _epoch_seconds(out_a), "validation": _validation_seconds(out_a)}


@contextlib.contextmanager
def _world1(dev):
    """This process as the one rank of a world of 1 over NCCL: its `Mesh`;
    the process group left and the environment restored after."""
    from hop_tpu_torch.parallel.local import free_port
    from hop_tpu_torch.parallel.mesh import destroy, init_distributed
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh = init_distributed(dev, data_parallel=1)
        check(mesh.backend == "nccl" and mesh.world == 1, f"world 1: {mesh}")
        yield mesh
    finally:
        destroy()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_parallel(dev, seed):
    """Phase 29. Returns ({path name: launches}, the kernels at new shapes)."""
    import torch
    from hop_tpu_torch.cli.test_checkpoint import N_SPEAKERS
    from hop_tpu_torch.data.synthetic import make_train_batch
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.parallel.local import run_ranks
    from hop_tpu_torch.utils.checkpoint import differing_entries
    from hop_tpu_torch.cli.train_main import deterministic_cudnn
    import concurrent.futures
    smi = _smi()
    deterministic_cudnn(dev)       # the runs compared bitwise, as a training run sets it
    kernels = phase_parallel_kernels(dev, seed)     # timed with the card to itself
    paths = {}
    two_cards = torch.cuda.device_count() >= 2
    backend, device = ("nccl", "cuda") if two_cards else ("gloo", "cuda:0")
    tmp = tempfile.mkdtemp(prefix="hop_par_")
    gate = os.path.join(tmp, "runs_ended")
    # the training runs beside the comparisons (nothing timed meanwhile); the
    # ranks time their steps after the gate opens
    pool = concurrent.futures.ThreadPoolExecutor(1)
    run_future = pool.submit(_par_run_ted, seed, backend, device, tmp, gate)
    cfg = ted_route_config()
    model_cpu = build_hop_model(cfg, N_SPEAKERS, seed, "cpu")
    disc_cpu = build_discriminator(cfg, seed + 1, "cpu")
    batch = make_train_batch(cfg, cfg.train.batch_size, seed, N_SPEAKERS, dev)

    # world size 1 over NCCL: bitwise the one-process steps (phase 9's setting)
    model, disc = _par_nets(model_cpu, disc_cpu, dev, exact=False)
    plain = _par_steps(cfg, model, disc, batch, None, seed)[0].state_dict()
    with _world1(dev) as mesh:
        model, disc = _par_nets(model_cpu, disc_cpu, dev, exact=False)
        state, _, _, _, paths["parallel_world1"], _ = _par_steps(cfg, model, disc, batch,
                                                                 mesh, seed)
        diff = differing_entries(plain, state.state_dict())
        check(diff == [], f"world 1 over NCCL differs from one process at {diff[:5]}")
        del model, disc, state, plain
    print(f"parallel world 1: {PAR_STEPS} fused GAN steps at bs {cfg.train.batch_size} "
          f"through init_distributed (NCCL, one rank), the RankAdam's all-reduce and the "
          f"rank's draws: every checkpoint entry bitwise the one-process steps'")

    # the one-process reference of world 2's steps
    model, disc = _par_nets(model_cpu, disc_cpu, dev, exact=True)
    _, _, _, metrics, _, grads = _par_steps(cfg, model, disc, batch, None, seed)
    try:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"metrics": metrics, "snap": _par_snapshot(model, disc, grads)}, ref_path)
        del model, disc, model_cpu, disc_cpu, batch
        torch.cuda.empty_cache()
        spec = {"seed": seed, "ref": ref_path, "out": os.path.join(tmp, "rank"),
                "backend": backend, "device": device, "gate": gate}
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        t0 = time.perf_counter()
        results = run_ranks([os.path.abspath(__file__), "--rank", os.path.join(tmp, "spec.pt")],
                            2, PAR_TIMEOUT, {"PYTHONPATH": os.path.dirname(
                                os.path.abspath(__file__))}, threads=4)
        spawn_s = time.perf_counter() - t0
        bad = [r for r in results if r.returncode != 0]
        check(not bad, "phase 29's ranks failed:\n" + "\n".join(
            f"--- rank {r.rank} exited {r.returncode}:\n{r.output[-3000:]}" for r in bad))
        ranks = [torch.load(f"{spec['out']}.{r}.pt", weights_only=False) for r in range(2)]
        sharing = "" if two_cards else ", both ranks sharing one card (not a scaling number)"
        want = {k: PAR_STEPS * v for k, v in step_launches(cfg, 4, True).items()}
        for r, out in enumerate(ranks):
            dp = out["dp"]
            paths[f"parallel_dp_rank{r}"] = dp["zero"]["launches"]
            check(dp["zero"]["launches"] == want, f"rank {r}: launches in {PAR_STEPS} steps "
                  f"{dp['zero']['launches']}, want {want}")
            check(dp["zero_vs_no_zero"] == [], f"rank {r}: ZeRO vs --no-zero2 differ at "
                                               f"{dp['zero_vs_no_zero'][:5]}")
            for name in ("zero", "no_zero"):
                e = dp[name]
                check(e["loss"] <= PAR_LOSS_TOL and e["grad"] <= PAR_GRAD_TOL
                      and e["param_lr"] <= PAR_PARAM_LR,
                      f"rank {r} world 2 vs 1 ({name}): losses {e['loss']:.3e} (tol "
                      f"{PAR_LOSS_TOL:g}), worst gradient {e['grad_at']} {e['grad']:.3e} "
                      f"(tol {PAR_GRAD_TOL:g}), parameters {e['param_lr']:.3f} lr (tol "
                      f"{PAR_PARAM_LR:g})")
            f = dp["fault"]
            check(f["loss"] > PAR_LOSS_TOL and f["grad"] > PAR_GRAD_TOL
                  and f["param_lr"] > PAR_PARAM_LR,
                  f"rank {r}: the planted fault (GRU output x {PAR_FAULT}) passed a limit: "
                  f"losses {f['loss']:.3e}, gradient {f['grad']:.3e}, parameters "
                  f"{f['param_lr']:.3f} lr")
            ms, device_ms, busy, top, peak = dp["timing"]
            e = dp["zero"]
            print(f"parallel world 2 rank {r} ({out['backend']} on {out['device']}{sharing}): "
                  f"{PAR_STEPS} fused GAN steps at global bs {cfg.train.batch_size} ({dp['local_batch']} "
                  f"rows a rank), dropout off, backbone f32, against one process: losses rel "
                  f"{e['loss']:.3e} (tol {PAR_LOSS_TOL:g}), worst gradient of the first step "
                  f"{e['grad_at']} over its net's largest "
                  f"{e['grad']:.3e} (tol {PAR_GRAD_TOL:g}), parameters where the first "
                  f"gradient is {PAR_RESOLVED:g} of its net's largest or more "
                  f"{e['param_lr']:.3f} lr (tol {PAR_PARAM_LR:g}; everywhere "
                  f"{e['param_all']:.3f} lr); --no-zero2 {dp['no_zero']['loss']:.3e} / "
                  f"{dp['no_zero']['grad']:.3e} / {dp['no_zero']['param_lr']:.3f}; ZeRO "
                  f"({dp['zero_sharded']} moments sharded) vs --no-zero2 bitwise; planted "
                  f"fault (GRU x {PAR_FAULT}) {f['loss']:.3e} / {f['grad']:.3e} / "
                  f"{f['param_lr']:.3f} lr (everywhere {f['param_all']:.3f}), caught by each; "
                  f"launches {_nonzero(dp['zero']['launches'])}; phase 9's step (bf16, dropout "
                  f"on, ZeRO): {ms:.2f} ms per step, kernels "
                  f"{device_ms:.2f} ms, busy share {busy:.3f} (CUDA-event median of 3; "
                  f"torch.profiler, 2 steps), peak {peak:.2f} GiB; on {smi}; seconds "
                  + ", ".join(f"{k} {v:.1f}" for k, v in dp["clock"].items()))
        tp0, tp1 = ranks[0]["tp"], ranks[1]["tp"]
        check(tp1["same_as_rank0"], "model = 2: the ranks' forwards differ")
        check(tp0["fwd_err"] <= SERVE_TOL and tp0["loss_err"] <= TRAIN_LOSS_TOL
              and tp0["grad_err"] <= TRAIN_GRAD_TOL,
              f"LLaMA model = 2 vs model = 1: forward {tp0['fwd_err']:.3e} (tol {SERVE_TOL:g}), "
              f"losses {tp0['loss_err']:.3e} (tol {TRAIN_LOSS_TOL:g}), gradient "
              f"{tp0['grad_at']} {tp0['grad_err']:.3e} (tol {TRAIN_GRAD_TOL:g})")
        for r, out in enumerate(ranks):
            paths[f"parallel_tp_rank{r}"] = out["tp"]["launches"]
        print(f"parallel model = 2 (LLaMA-7B backbone, {llama_route_config().llm.n_layers} "
              f"layers, {ranks[0]['backend']}{sharing}): bs-256 forward and one fused GAN step "
              f"against model = 1: forward max_abs_diff {tp0['fwd_err']:.3e} (tol "
              f"{SERVE_TOL:g}), losses rel {tp0['loss_err']:.3e} (tol {TRAIN_LOSS_TOL:g}), worst "
              f"gradient {tp0['grad_at']} {tp0['grad_err']:.3e} (tol {TRAIN_GRAD_TOL:g}); the "
              f"ranks' forwards bitwise equal; backbone share {tp0['backbone_gib']:.2f} GiB a "
              f"rank; peak memory of the forward and the step (torch.cuda.max_memory_allocated): "
              f"rank 0 {tp0['peak_gib']:.2f} GiB, rank 1 {tp1['peak_gib']:.2f} GiB (phase 24's "
              f"one-process step: 19.4 GiB, PERF.md); "
              f"launches rank 0 {_nonzero(tp0['launches'])}; seconds " + ", ".join(
                  f"{k} {v:.1f}" for k, v in tp0["clock"].items())
              + f"; the ranks took {spawn_s:.1f} s")
        run = run_future.result()
        print(f"parallel run_ted: --data-parallel 2 ({backend}{sharing}) at full TED width, "
              f"BERT cut to 2 layers, global bs 16 on 1 synthetic video, 2 epochs against 1 "
              f"+ --resume to 2: the checkpoints equal in all {run['entries']} entries "
              f"(ZeRO's moments gathered), metrics.jsonl equal; seconds "
              f"{', '.join(f'{s:.1f}' for s in run['seconds'])} (2 epochs and 1 epoch side by "
              f"side, then the resume, beside the comparisons; host clock); the 2-epoch run's epochs "
              f"{run['epochs']} s, validation passes {run['validation']} s")
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return paths, kernels


# ---- phase 30: the hierarchy on a split batch (ROADMAP M15b) -----------------
# Two GAN steps of the TED hierarchy at published widths, global bs 256, on
# the fused GRU route, on 2 ranks (gloo on one card, or NCCL on two) against
# the same steps in one process: the same global batch and draws, dropout
# off, so that what is left is the order of f32 sums (the ranks' 128 rows,
# the batch statistics, the contrastive terms' rows against the gathered
# columns, the gradients summed over the ranks). Phase 29's three readings:
# the losses of both steps (relative), each gradient tensor of the first
# step, the parameters after two steps in units of the learning rate where
# the first step's gradient is at least PAR_RESOLVED of the largest; here
# over the largest of its module (the text encoder, each stage, the
# discriminator; `_module_of`), not its net, since a fault of the
# contrastive terms moves the text encoder, whose gradients are 1e-3 of the
# stages'. The audio encoder (ResNetSE) is read and printed but not held: its
# f32 split noise (128 rows a rank through cuDNN's convolutions and a few
# ReLUs that flip; in f64 the split equals one process to 1e-14, tests/
# test_torch_parallel_hierarchy.py) is 1.9e-3 of its largest gradient and
# 1.8 lr of its parameters, more than the first two faults below add there.
# The limits sit between the readings and three planted faults, each of
# which fails every one: the last stage's GRU output x PAR_FAULT on every
# rank; the contrastive terms over each rank's own pairs (4352 x 4352 in
# place of 4352 x 8704), the mistake a port without the gather makes; and
# the audio encoder's BatchNorms over the rank's own 128 rows
# (`_local_audio_bn`; `ranked` makes their statistics the global batch's),
# which holds the audio encoder's split through the modules that read its
# features. Readings (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): sound
# losses 2.1e-4, gradients 1.3e-6 (stage 3), parameters 0.37 lr (stage 3),
# text 0.024 lr; the GRU fault 2.1e-2, 3.6e-4, 1.94 lr; the local pairs
# 7.6e-2, 7.4e-3 (text), text 0.12 lr; the local audio BatchNorms 1.7e-1,
# 5.0e-2 (text), 2.0 lr (the stages), text 3.7 lr (the audio encoder's own
# gradients 0.66 of their largest). Adam moves a resolved element by about
# lr sign(g) in its first steps, so a fault that changes the text encoder's
# gradients by ~1% flips few signs: the text encoder's parameters have a
# limit of their own.
HPAR_STEPS = 2
HPAR_LOSS_TOL = 2e-3
HPAR_GRAD_TOL = 1e-5
HPAR_PARAM_LR = {"text": 0.06}      # the other modules PAR_PARAM_LR
HPAR_APART = "audio"
HPAR_KEYS = PAR_KEYS + ("c_pos", "c_neg", "phy")


def _module_of(name: str) -> str:
    """The top-level module of the hierarchy's nets a parameter of
    `_par_trainable` belongs to: the audio encoder, the text encoder, each
    stage, the discriminator."""
    if name.startswith("D."):
        return "D"
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "stages" else parts[0]


def _hpar_held(e: dict) -> tuple:
    """A run's three held readings from `_par_errors` by module: the losses'
    relative error, the worst gradient over its module's largest, and the
    worst parameter reading over its module's limit (1 at the limit); the
    audio encoder left out."""
    held = {m: v for m, v in e["by_group"].items() if m != HPAR_APART}
    return (e["loss"], max(g for g, _ in held.values()),
            max(q / HPAR_PARAM_LR.get(m, PAR_PARAM_LR) for m, (_, q) in held.items()))


def _hpar_reading(e: dict) -> str:
    """A run's readings as one clause: the worst loss, and each module's
    gradient / parameter reading (the audio encoder's too)."""
    return (f"losses {e['loss']:.3e} ({e['loss_at'][0]}, step {e['loss_at'][1] + 1}); by "
            f"module gradient / parameters (lr): " + ", ".join(
                f"{m} {g:.2e} / {q:.3f}" for m, (g, q) in e["by_group"].items())
            + f"; everywhere {e['param_all']:.3f} lr")
# K2 and K3 at a rank's rows: the first stage's first layer (I = 96) and the
# discriminator's (T = 28, I = 8, H = 64), (T, B, I, H, D) and (D, T, B, H)
HPAR_K2 = ((34, 128, 96, 300, 2), (28, 128, 8, 64, 2))
HPAR_K3 = ((2, 34, 128, 300), (2, 28, 128, 64))


def _hpar_build(zoo, dev, mesh=None, exact: bool = True, fault: str = None):
    """The hierarchy's state, GAN step and batch as `train_main` builds them
    (on a rank of `mesh`: its nets, steps and rows); `exact`: dropout off;
    `fault` "gru" plants the last stage's GRU output x PAR_FAULT."""
    _, state, _, gan, batch = zoo.build("hierarchy", "fused", dev, mesh=mesh)
    if exact:
        for m in (*state.model.modules(), *state.disc.modules()):
            for rate in ("dropout", "emb_dropout", "dropout_rate", "attention_dropout"):
                if isinstance(getattr(m, rate, None), float):
                    setattr(m, rate, 0.0)
    if fault == "gru":
        state.model.stages[-1].gru.register_forward_hook(
            lambda m, i, o: (o[0] * PAR_FAULT, *o[1:]))
    return state, gan, batch


def _hpar_steps(state, gan, batch, seed: int):
    """HPAR_STEPS GAN steps from the step generator seeded `seed`: (state,
    [metrics a step], launches, the first step's gradients on the host)."""
    import torch
    g, metrics, grads = torch.Generator().manual_seed(seed), [], None
    _reset_counts()
    for _ in range(HPAR_STEPS):
        state, m = gan(state, batch, g)
        metrics.append({k: v.item() for k, v in m.items()})
        grads = grads or {k: p.grad.cpu() for k, p in
                          _par_trainable(state.model, state.disc).items() if p.grad is not None}
    torch.cuda.synchronize()
    return state, metrics, _launch_counts(), grads


def _local_pairs():
    """The planted fault: `softmax_contrastive` over the rank's own rows of
    both feature blocks (its group dropped)."""
    from unittest import mock
    from hop_tpu_torch.train import hierarchy as TH
    whole = TH.softmax_contrastive
    return mock.patch.object(TH, "softmax_contrastive",
                             lambda a, b, chunk_pairs=TH.CONTRASTIVE_CHUNK_PAIRS, group=None:
                             whole(a, b, chunk_pairs))


def _local_audio_bn():
    """The planted fault: the audio encoder's BatchNorms (the centred ones,
    `CenteredBatchNorm2d`) over the rank's own rows, as if its nets were not
    built through `ranked`; the discriminator's keep the global batch's."""
    from unittest import mock
    from hop_tpu_torch.models import common
    whole = common.global_mean_var

    def local(x, dims, group, centered=False):
        if not centered:
            return whole(x, dims, group, centered)
        mean = x.mean(dims)
        dev = x - mean.reshape([1, -1] + [1] * (x.dim() - 2))
        return mean, (dev * dev).mean(dims)
    return mock.patch.object(common, "global_mean_var", local)


HPAR_FAULTS = {"fault_gru": (f"the last stage's GRU output x {PAR_FAULT}", "gru"),
               "fault_pairs": ("the contrastive terms over local pairs", "pairs"),
               "fault_bn": ("the audio encoder's BatchNorms over local rows", "bn")}


def _rank_hier(mesh, spec, dev) -> dict:
    """World 2 over the batch, the hierarchy: the exact steps with ZeRO,
    without, and with each planted fault, against the reference; then the
    default step (dropout on, ZeRO) timed."""
    import torch
    from hop_tpu_torch.utils.checkpoint import differing_entries
    zoo = _Zoo(spec["cfg"], spec["data"], spec["seed"], dev)
    ref = torch.load(spec["ref"], weights_only=False)
    out, states, clock = {}, {}, {"set up": time.perf_counter() - spec["t0"]}
    runs = [("zero", True, None), ("no_zero", False, None)] + [
        (name, True, fault) for name, (_, fault) in HPAR_FAULTS.items()]
    for name, zero, fault in runs:
        t0 = time.perf_counter()
        mesh.zero2 = zero
        state, gan, batch = _hpar_build(zoo, dev, mesh, fault=fault)
        with {"pairs": _local_pairs, "bn": _local_audio_bn}.get(
                fault, contextlib.nullcontext)():
            state, metrics, launches, grads = _hpar_steps(state, gan, batch, spec["seed"])
        out[name] = _par_errors(metrics, _par_snapshot(state.model, state.disc, grads), ref,
                                zoo.cfg, HPAR_KEYS, _module_of)
        out[name]["launches"] = launches
        if fault is None:
            states[name] = state.state_dict()
        clock[name] = time.perf_counter() - t0
        del state, gan
    out["zero_vs_no_zero"] = differing_entries(states["zero"], states["no_zero"])
    del states
    torch.cuda.empty_cache()
    mesh.zero2 = True
    state, gan, batch = _hpar_build(zoo, dev, mesh, exact=False)
    out["zero_sharded"] = sum(ax is not None for ax in state.gen_opt.axes)
    g = torch.Generator().manual_seed(spec["seed"])
    t0 = time.perf_counter()
    while not os.path.exists(spec["gate"]):
        check(time.perf_counter() - t0 < PAR_TIMEOUT, "phase 30: the gate never opened")
        time.sleep(0.1)
    clock["waiting"], t0 = time.perf_counter() - t0, time.perf_counter()

    def step():
        nonlocal state
        state, _ = gan(state, batch, g)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, reps=3, warmup=1)
    busy, device_ms, top = _busy_share(step, 1, ms, host_ops=False)
    out["timing"] = (ms, device_ms, busy, top, torch.cuda.max_memory_allocated() / 2 ** 30)
    clock["timing"] = time.perf_counter() - t0
    out["local_batch"], out["clock"] = int(batch["target_vec"].shape[0]), clock
    return out


def phase_parallel_hierarchy(dev, seed, ted):
    """Phase 30 on `zoo_data`'s TED records. Returns ({path name: launches},
    the kernels at a rank's shapes)."""
    import concurrent.futures
    import torch
    from hop_tpu_torch.cli.train_main import deterministic_cudnn
    from hop_tpu_torch.parallel.local import run_ranks
    from hop_tpu_torch.utils.checkpoint import differing_entries
    smi = _smi()
    t_phase = time.perf_counter()
    deterministic_cudnn(dev)       # the runs compared bitwise, as a training run sets it
    kernels = phase_zoo_kernels(dev, seed, HPAR_K2, HPAR_K3, "hierarchy rank")
    clock = {"kernels": time.perf_counter() - t_phase}
    paths = {}
    two_cards = torch.cuda.device_count() >= 2
    backend, device = ("nccl", "cuda") if two_cards else ("gloo", "cuda:0")
    tmp = tempfile.mkdtemp(prefix="hop_hpar_")
    gate = os.path.join(tmp, "runs_ended")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    run_future = pool.submit(_par_run_ted, seed, backend, device, tmp, gate,
                             ("--model", "hierarchy"))
    try:
        # world size 1 over NCCL: bitwise the one-process steps (dropout on)
        t0 = time.perf_counter()
        plain = _hpar_steps(*_hpar_build(ted, dev, exact=False), seed)[0].state_dict()
        with _world1(dev) as mesh:
            state, paths["hier_parallel_world1"] = _hpar_steps(
                *_hpar_build(ted, dev, mesh, exact=False), seed)[::2]
            diff = differing_entries(plain, state.state_dict())
            check(diff == [], f"hierarchy world 1 over NCCL differs from one process at "
                              f"{diff[:5]}")
            del state, plain
        # the one-process reference of world 2's steps
        state, gan, batch = _hpar_build(ted, dev)
        state, metrics, launches, grads = _hpar_steps(state, gan, batch, seed)
        want = {k: HPAR_STEPS * v for k, v in zoo_launches(
            "hierarchy", state.model, "gan", "fused", state.disc).items()}
        check(launches == want, f"hierarchy one process: launches {launches}, want {want}")
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"metrics": metrics, "snap": _par_snapshot(state.model, state.disc, grads)},
                   ref_path)
        del state, gan, batch, grads
        torch.cuda.empty_cache()
        clock["world 1 and the reference"] = time.perf_counter() - t0
        print(f"parallel hierarchy world 1: {HPAR_STEPS} GAN steps at bs "
              f"{ted.cfg.train.batch_size} through init_distributed (NCCL, one rank), the "
              f"RankAdam's all-reduce and the rank's draws: every checkpoint entry bitwise "
              f"the one-process steps'")
        spec = {"kind": "hierarchy", "seed": seed, "ref": ref_path, "data": ted.data,
                "cfg": ted.cfg,
                "out": os.path.join(tmp, "rank"), "backend": backend, "device": device,
                "gate": gate}
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        t0 = time.perf_counter()
        results = run_ranks([os.path.abspath(__file__), "--rank", os.path.join(tmp, "spec.pt")],
                            2, PAR_TIMEOUT, {"PYTHONPATH": os.path.dirname(
                                os.path.abspath(__file__))}, threads=4)
        clock["ranks"] = time.perf_counter() - t0
        bad = [r for r in results if r.returncode != 0]
        check(not bad, "phase 30's ranks failed:\n" + "\n".join(
            f"--- rank {r.rank} exited {r.returncode}:\n{r.output[-3000:]}" for r in bad))
        ranks = [torch.load(f"{spec['out']}.{r}.pt", weights_only=False) for r in range(2)]
        sharing = "" if two_cards else ", both ranks sharing one card (not a scaling number)"
        for r, out in enumerate(ranks):
            dp = out["dp"]
            paths[f"hier_parallel_dp_rank{r}"] = dp["zero"]["launches"]
            check(dp["zero"]["launches"] == want, f"hierarchy rank {r}: launches in "
                  f"{HPAR_STEPS} steps {dp['zero']['launches']}, want {want}")
            check(dp["zero_vs_no_zero"] == [], f"hierarchy rank {r}: ZeRO vs --no-zero2 "
                                               f"differ at {dp['zero_vs_no_zero'][:5]}")
            for name in ("zero", "no_zero"):
                loss, grad, param = _hpar_held(dp[name])
                check(loss <= HPAR_LOSS_TOL and grad <= HPAR_GRAD_TOL and param <= 1.0,
                      f"hierarchy rank {r} world 2 vs 1 ({name}): losses {loss:.3e} (tol "
                      f"{HPAR_LOSS_TOL:g}), gradients {grad:.3e} (tol {HPAR_GRAD_TOL:g}), "
                      f"parameters {param:.2f} of their module's limit; "
                      f"{_hpar_reading(dp[name])}")
            for name, (what, _) in HPAR_FAULTS.items():
                loss, grad, param = _hpar_held(dp[name])
                check(loss > HPAR_LOSS_TOL and grad > HPAR_GRAD_TOL and param > 1.0,
                      f"hierarchy rank {r}: the planted fault ({what}) passed a limit: "
                      f"{_hpar_reading(dp[name])}")
            ms, device_ms, busy, top, peak = dp["timing"]
            reading = _hpar_reading
            print(f"parallel hierarchy world 2 rank {r} ({out['backend']} on "
                  f"{out['device']}{sharing}): {HPAR_STEPS} GAN steps at global bs "
                  f"{ted.cfg.train.batch_size} ({dp['local_batch']} rows a rank), dropout "
                  f"off, against one process; limits: losses {HPAR_LOSS_TOL:g} relative, each "
                  f"first-step gradient tensor {HPAR_GRAD_TOL:g} of its module's largest "
                  f"(the text encoder, each stage, the discriminator; the audio encoder "
                  f"read, not held), parameters {PAR_PARAM_LR:g} lr (the text encoder "
                  f"{HPAR_PARAM_LR['text']:g}) where the first gradient is {PAR_RESOLVED:g} "
                  f"of its module's largest or more. ZeRO: "
                  f"{reading(dp['zero'])}; --no-zero2: {reading(dp['no_zero'])}; ZeRO "
                  f"({dp['zero_sharded']} moments sharded) vs --no-zero2 bitwise; planted "
                  f"faults, each caught by every limit: GRU x {PAR_FAULT}: "
                  f"{reading(dp['fault_gru'])}; local pairs: "
                  f"{reading(dp['fault_pairs'])}; local audio BatchNorms: "
                  f"{reading(dp['fault_bn'])}; "
                  f"launches {_nonzero(dp['zero']['launches'])}; the default step (dropout "
                  f"on, ZeRO): {ms:.2f} ms per step, kernels {device_ms:.2f} ms, busy share "
                  f"{busy:.3f} (CUDA-event median of 3; torch.profiler, 1 step, the card's "
                  f"activity alone), peak {peak:.2f} GiB; top: "
                  + ", ".join(f"{k} {t:.2f}" for k, t in top[:4]) + f"; on {smi}; seconds "
                  + ", ".join(f"{k} {v:.1f}" for k, v in dp["clock"].items()))
        run = run_future.result()
        print(f"parallel hierarchy run_ted: --model hierarchy --data-parallel 2 "
              f"({backend}{sharing}) at full TED width, global bs 16 on 1 synthetic video, 2 "
              f"epochs against 1 + --resume to 2: the checkpoints equal in all "
              f"{run['entries']} entries (ZeRO's moments gathered), metrics.jsonl equal; "
              f"seconds {', '.join(f'{s:.1f}' for s in run['seconds'])} (2 epochs and 1 "
              f"epoch side by side, then the resume, beside the comparisons; host clock); "
              f"the 2-epoch run's epochs {run['epochs']} s, validation passes "
              f"{run['validation']} s")
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"parallel hierarchy: phase 30 in {time.perf_counter() - t_phase:.1f} s on {smi} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()) + ")")
    return paths, kernels


class _Laps:
    """Seconds of the phases (host clock): each call closes the span since
    the last under its name."""

    def __init__(self):
        self.seconds, self.t = {}, time.perf_counter()

    def __call__(self, name: str):
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hop_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    lap = _Laps()

    phase_device()
    phase_build()
    lap("1-2")
    k1 = phase_k1(dev, SEED)
    lap("3")
    k2 = phase_k2(dev, SEED)
    lap("4")
    paths = {}      # kernel launches of each driven path, counted from zero
    model, paths["serve_fused"], out_fused = phase_serve(dev, SEED)
    phase_clips(model, dev)
    lap("5-6")
    k1_bwd = phase_k1_bwd(dev, SEED)
    lap("7")
    k2_bwd = phase_k2_bwd(dev, SEED)
    lap("8")
    model_cpu, disc_cpu, paths["fused_step"] = phase_train(dev, SEED)
    _, _, paths["fused_step_stack"] = phase_train(dev, SEED, gru_kernel="stack")
    phase_warmup_vs_cpu(model_cpu, disc_cpu, dev, SEED)
    del model_cpu, disc_cpu
    lap("9-10")
    k3 = phase_k3_fwd(dev, SEED)
    k3_bwd = phase_k3_bwd(dev, SEED)
    lap("11-12")
    k6, paths["seq_forward"] = phase_k6(model.gru, dev, SEED)
    lap("13")
    del model
    model, paths["serve_stack"], _ = phase_serve(dev, SEED, "stack", out_fused)
    phase_clips(model, dev, "stack")
    del out_fused
    lap("14")
    attn_paths = phase_serve_attention(model, dev, SEED)
    paths["serve_stack_fused_attn"] = attn_paths["fused"]
    paths["serve_stack_block_attn"] = attn_paths["block"]
    paths["clip_stack_fused_attn"] = attn_paths["clip_fused"]
    paths["clip_stack_block_attn"] = attn_paths["clip_block"]
    del model
    model_cpu, disc_cpu, paths["parity_step_stack"] = phase_train(
        dev, SEED, gru_kernel="stack", fused_step=False)
    phase_warmup_vs_cpu(model_cpu, disc_cpu, dev, SEED, "stack", fused_step=False)
    del model_cpu, disc_cpu
    lap("15-16, 19")
    attn = phase_bert_attention(dev, SEED)
    lap("18")
    _, _, paths["fused_step_stack_fused_attn"] = phase_train(
        dev, SEED, gru_kernel="stack", attention="fused")
    model_cpu, disc_cpu, paths["fused_step_stack_block_attn"] = phase_train(
        dev, SEED, gru_kernel="stack", attention="block")
    phase_warmup_vs_cpu(model_cpu, disc_cpu, dev, SEED, "stack", attention="block")
    del model_cpu, disc_cpu
    _, _, paths["parity_step_stack_fused_attn"] = phase_train(
        dev, SEED, gru_kernel="stack", fused_step=False, attention="fused")
    _, _, paths["parity_step_stack_block_attn"] = phase_train(
        dev, SEED, gru_kernel="stack", fused_step=False, attention="block")
    lap("20")
    lib = phase_library(dev, SEED)
    lap("17")
    paths.update(phase_eval(dev, SEED))
    lap("21")
    # the training entry point sets cuDNN's deterministic algorithms: last
    paths["train_run"] = phase_run(dev, SEED)
    lap("22")
    paths.update(phase_import(dev, SEED))
    lap("23")
    paths.update(phase_llama(dev, SEED))
    lap("24")
    zoo = phase_zoo_kernels(dev, SEED)
    tmp = tempfile.mkdtemp(prefix="hop_zoo_")
    try:
        ted, expr = zoo_data(dev, SEED, tmp)
        paths.update(phase_zoo(dev, SEED, ted, expr, tmp))
        lap("25")
        paths.update(phase_expressive(dev, SEED, ted, expr, tmp))
        lap("26")
        hier = phase_zoo_kernels(dev, SEED, HIER_K2, (), "hierarchy")
        paths.update(phase_hierarchy(dev, SEED, ted, expr, tmp))
        lap("27")
        del expr
        paths.update(phase_export(dev, SEED))
        lap("28")
        par_paths, par = phase_parallel(dev, SEED)
        paths.update(par_paths)
        lap("29")
        # the TED records of phase 25 serve the hierarchy's ranks
        hpar_paths, hpar = phase_parallel_hierarchy(dev, SEED, ted)
        paths.update(hpar_paths)
        lap("30")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("chip_smoke: seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in lap.seconds.items())
        + f"; 1-24 {sum(v for k, v in lap.seconds.items() if k not in ('25', '26', '27', '28', '29', '30')):.1f}")

    # launches: over one run of each path (a bs-256 forward on either GRU route
    # and on each attention route, a clip at bs 1 on each kernel attention
    # route, the head through the sequence kernel, one GAN step of each kind);
    # errors: every comparison of that kernel with its plain version in this
    # run; times and bounds at the head's first layer or K1's shape
    def entry(name, source, replaces, count, err, timed, library_ms, **own):
        by_path = {path: c[count] for path, c in paths.items()}
        check(sum(by_path.values()) > 0, f"{name} was launched on no path")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": err, "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                "library_ms": library_ms, **own}
    k3_head = k3["head"]

    def zoo_err(key):
        return max(r["max_abs_err"] for r in [*zoo[key].values(), *hier[key].values(),
                                               *hpar[key].values()])

    def zoo_rows(key):
        """The zoo's shapes of a kernel (phase 25), the hierarchy's (phase 27)
        and the hierarchy's at a rank's rows (phase 30), under keys of their
        own."""
        return {name: {",".join(map(str, shape)): r for shape, r in rows[key].items()}
                for name, rows in (("zoo", zoo), ("hierarchy", hier),
                                   ("hierarchy_rank", hpar)) if rows[key]}

    def _at(I, r, library_ms):
        """K2 at a head's first layer (I = 4320 on LLaMA, 1751 on TED
        Expressive): its error, time, bound and cuDNN's time, under keys of
        their own."""
        return {f"i{I}_{k}": r[k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")} | {
                    f"i{I}_library_ms": library_ms}
    def par_rows(name, bwd=False):
        """Phase 29's shapes of a kernel (a rank's rows, a rank's heads), under
        keys of their own: forward or backward ms, plain ms, bound, library ms."""
        pre = "bwd_" if bwd else ""
        return {shape: {"err": r["bwd_rel" if bwd else "max_abs_err"],
                        "ms": r[pre + "ms"], "plain_ms": r[pre + "plain_ms"],
                        "bound_ms": r[pre + "bound_ms"], "bound_by": r[pre + "bound_by"],
                        "library_ms": r["library_bwd_ms" if bwd else "library_ms"]}
                for shape, r in par[name].items()}
    kernels = [
        entry("reprogramming_attention_fwd", K1_SOURCE, K1_REPLACES, "K1",
              max(k1["max_abs_err"], k1_bwd["out_err"]), k1, lib["K1"],
              rank_rows=par_rows("K1")),
        # SDPA's backward alone at rate 0 (no one call draws the hashed mask)
        entry("reprogramming_attention_bwd", K1_SOURCE, K1_BWD_REPLACES, "K1_bwd",
              k1_bwd["max_abs_err"], k1_bwd, lib["K1_bwd"],
              rank_rows=par_rows("K1", bwd=True)),
        entry("gru_fused_fwd", K2_SOURCE, K2_REPLACES, "K2",
              max([r["max_abs_err"] for r in k2.values()]
                  + [r["fwd_err"] for r in k2_bwd.values()] + [zoo_err("K2")]),
              k2[K2_MAIN[0]], lib[("gru_fwd", 992, 350)],
              disc_rec_kernel_ms=k2[K2_MAIN[2]]["rec_ms"],
              **_at(4320, k2[K2_LLAMA], lib[("gru_fwd", 4320, 350)]),
              **_at(1751, k2[K2_EXPR], lib[("gru_fwd", 1751, 350)]), **zoo_rows("K2"),
              rank_rows=par_rows("K2")),
        entry("gru_fused_bwd", K2_SOURCE, K2_BWD_REPLACES, "K2_bwd",
              max([r["max_abs_err"] for r in k2_bwd.values()] + [zoo_err("K2_bwd")]),
              k2_bwd[(992, 350)], lib[("gru_bwd", 992, 350)],
              **_at(4320, k2_bwd[(4320, 350)], lib[("gru_bwd", 4320, 350)]),
              **_at(1751, k2_bwd[(1751, 350)], lib[("gru_bwd", 1751, 350)]),
              **zoo_rows("K2_bwd"), rank_rows=par_rows("K2", bwd=True)),
        # K3 is the recurrence without its projection: no one call computes it
        entry("gru_stack_fwd", K3_SOURCE, K3_REPLACES, "K3",
              max(k3["max_abs_err"], zoo_err("K3")),
              {**k3_head, **k3_head["bound"]}, None,
              disc_kernel_ms=k3["disc_kernel_ms"], disc_bound_ms=k3["disc_bound_ms"],
              **zoo_rows("K3")),
        entry("gru_stack_fwd_lean", K3_SOURCE, K3_LEAN_REPLACES, "K3_lean",
              max(k3["lean_max_abs_err"], zoo_err("K3_lean")),
              {"ms": k3_head["lean_ms"], "plain_ms": k3_head["lean_plain_ms"],
               **k3_head["lean_bound"]}, None,
              disc_kernel_ms=k3["disc_lean_kernel_ms"],
              disc_bound_ms=k3["disc_lean_bound_ms"], **zoo_rows("K3_lean")),
        entry("gru_stack_bwd", K3_SOURCE, K3_BWD_REPLACES, "K3_bwd",
              max(k3_bwd["max_abs_err"], zoo_err("K3_bwd")), k3_bwd["head"], None,
              **zoo_rows("K3_bwd")),
        entry("gru_seq_fwd", K6_SOURCE, K6_REPLACES, "K6", k6["max_abs_err"], k6,
              None, kernel_ms=k6["kernel_ms"], b1_kernel_ms=k6["b1_kernel_ms"],
              h64_kernel_ms=k6["h64_kernel_ms"]),
    ]
    # the backbone's self-attention: SDPA computes the forward at rate 0; its
    # backward alone stands beside the kernels' backward (at rate 0.1). Beside
    # the event time of one call: the kernel's own device time (the
    # backward's also at rate 0, like for like with SDPA's, and at B=1), the
    # library call's likewise
    for name, count, source, replaces in (
            ("bert_attention", "K4", K4_SOURCE, (K4_REPLACES, K4_BWD_REPLACES)),
            ("bert_block_attention", "K5", K5_SOURCE, (K5_REPLACES, K5_BWD_REPLACES))):
        r = attn[count]
        kernels.append(entry(name + "_fwd", source, replaces[0], count, r["fwd_err"],
                             {**r, **r["bound"]}, lib["attn_fwd"],
                             kernel_ms=r["kernel_ms"],
                             library_kernel_ms=lib["attn_fwd_kernel"],
                             rank_heads=par_rows(count)))
        kernels.append(entry(
            name + "_bwd", source, replaces[1], count + "_bwd", r["bwd_err"],
            {"ms": r["bwd_ms"], "plain_ms": r["bwd_plain_ms"], **r["bwd_bound"]},
            lib["attn_bwd"], kernel_ms=r["bwd_kernel_ms"],
            kernel_ms_rate0=r["bwd0_kernel_ms"], b1_kernel_ms=r["b1_bwd_kernel_ms"],
            library_kernel_ms=lib["attn_bwd_kernel"], rank_heads=par_rows(count, bwd=True)))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2])
    else:
        main()
