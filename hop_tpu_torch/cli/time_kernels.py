"""Times the port's kernels on the card, to hold a change to kernel code
against an older tree inside one run.

  python3 hop_tpu_torch/cli/time_kernels.py [--tree DIR] [--tag NAME] [--only K4 K5]

Run as a file from the repository root, with a CUDA card and nvcc. It
imports `hop_tpu_torch` from DIR (default: this checkout), builds that
tree's kernels into DIR/build/kernels_ab, and prints one line per kernel
call at the main path's shapes: the call's ms (CUDA-event median of 20
single calls), the ms per call of 50 calls between one pair of events (the
host's launches overlap the card's work), and the ms of every kernel it
launched (torch.profiler over 10 calls, `kernel_ms_by_name`). `--only` keeps the named kernels (K1,
K2, K3, K4, K5, K6). It uses only the wrappers' signatures, so an older
tree answers the same script:

  mkdir -p build/parent
  git archive <commit> hop_tpu_torch | tar -x -C build/parent
  for t in parent change change parent; do
    python3 hop_tpu_torch/cli/time_kernels.py \\
        --tree $([ $t = parent ] && echo build/parent || echo .) --tag $t
  done

Two cards, or one card at two power limits, give other times: compare only
the lines of one run. The kernels' own times repeat to about 3%; the calls'
include the host's launches and spread more.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

# (T, B, I, H, D) of the fused GRU layer: the head's two, the discriminator's
# two, the head's first at one window of a clip (bs 1), the head's first on
# the LLaMA backbone
K2_SHAPES = ((34, 256, 992, 350, 2), (34, 256, 700, 350, 2),
             (28, 256, 8, 64, 2), (28, 256, 128, 64, 2), (34, 1, 992, 350, 2),
             (34, 256, 4320, 350, 2))
# (D, T, B, H) of the time-grid recurrence: the head at bs 256 and bs 1, the
# discriminator. The recurrence kernels' own lines are `gru_fwd_cluster_kernel`
# / `gru_fwd_block_kernel` (forward: a cluster at H = 350, one block at
# H = 64) and `gru_bwd_resident_kernel` (backward) in each call's list.
K3_SHAPES = ((2, 34, 256, 350), (2, 34, 1, 350), (2, 28, 256, 64))
# (B, T, H) of the sequence kernel, one direction: the head's layer at bs 256
# and bs 1, and a narrow layer (the one-block kernel)
K6_SHAPES = ((256, 34, 350), (1, 34, 350), (256, 28, 64))
# (B, L, H, E, S) of the reprogramming attention
K1_SHAPE = (256, 34, 8, 128, 1500)
# (B, T, H, D) of the backbone's self-attention (K4, K5): bs 256 and one
# window of a clip
ATTN_SHAPES = ((256, 34, 12, 64), (1, 34, 12, 64))


def kernel_ms_by_name(fn, n: int = 10) -> dict:
    """Device time of each kernel that n calls of fn() launch, in ms per call,
    by the kernel's name (torch.profiler): its time per recorded launch (the
    total over `count`) times its launches a call (count / n, rounded). The
    profiler loses launches, most at the start of a window (SDPA's forward:
    3 of 10 calls in every window), so a total over n calls reads too fast:
    n calls run as a traced warm-up step first, and the next n are kept
    (less the step's own `ProfilerStep` span). A window counts when every
    kernel's count is within n / 4 of a whole number (at least one) of
    launches a call; else another is asked for, five times at most, a second
    apart, and the answer is {} with the last window's counts printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    counts = []
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        per_call = [max(1, round(e.count / n)) for e in events]
        if events and all(abs(e.count - k * n) <= n // 4 for e, k in zip(events, per_call)):
            return {e.key: e.self_device_time_total / 1e3 / e.count * k
                    for e, k in zip(events, per_call)}
        counts = [(e.key[:48], e.count) for e in events]
    print(f"kernel_ms_by_name: no window of {n} calls recorded whole in six; the last "
          f"held {counts}", flush=True)
    return {}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=".", help="directory that holds hop_tpu_torch/")
    parser.add_argument("--tag", default="tree", help="printed at the head of each line")
    parser.add_argument("--only", nargs="+", default=["K1", "K2", "K3", "K4", "K5", "K6"],
                        help="the kernels to time")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    os.environ["HOP_TPU_TORCH_BUILD_DIR"] = os.path.join(root, "build", "kernels_ab")

    import torch

    from hop_tpu_torch.ops import _build
    from hop_tpu_torch.ops import attention as K4
    from hop_tpu_torch.ops import block_attention as K5
    from hop_tpu_torch.ops import gru_fused as K2
    from hop_tpu_torch.ops import gru_seq as K6
    from hop_tpu_torch.ops import gru_stack as K3
    from hop_tpu_torch.ops import reprogramming_attention as K1
    if not os.path.abspath(K2.__file__).startswith(root + os.sep):
        sys.exit(f"time_kernels: hop_tpu_torch came from {K2.__file__}, not {root}")
    if not torch.cuda.is_available():
        sys.exit("time_kernels: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[{args.tag}] {smi}; {root}; built in {_build.build_seconds:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(2021)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def show(name, fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(50):
            fn()
        end.record()
        end.synchronize()
        loop = start.elapsed_time(end) / 50
        kernels = sorted(((ms, key) for key, ms in kernel_ms_by_name(fn).items()),
                         reverse=True)
        parts = "; ".join(f"{key.split('(anonymous namespace)::', 1)[-1][:48]} {ms:.3f}"
                          for ms, key in kernels) or "kernels not recorded"
        print(f"[{args.tag}] {name}: {statistics.median(times):.3f} ms (loop {loop:.3f}) "
              f":: {parts}", flush=True)

    if "K2" in args.only:
        for shape in K2_SHAPES:
            T, B, I, H, D = shape
            s = H ** -0.5
            layer = (randn(T, B, I), randn(D, 3, I, H, scale=s), randn(D, 3, 1, H, scale=s),
                     randn(D, 3, H, H, scale=s), randn(D, 3, 1, H, scale=s),
                     randn(B, H, scale=0.5))
            g = randn(D, T, B, H)
            show(f"K2 fwd lean {shape}", lambda: K2.gru_fused_layer(*layer))
            show(f"K2 fwd res {shape}",
                 lambda: K2.gru_fused_layer_fwd(*layer, with_residuals=True))
            h_seq, r, z, n, hnb = K2.gru_fused_layer_fwd(*layer, with_residuals=True)
            bwd = (g, layer[0], r, z, n, hnb, K2.hprev_of(h_seq, layer[5]), layer[1], layer[3])
            show(f"K2 bwd {shape}", lambda: K2.gru_fused_layer_bwd(*bwd))
    if "K3" in args.only:
        for shape in K3_SHAPES:
            D, T, B, H = shape
            s = H ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                proj = randn(T, B, D, 3, H).to(dtype)
                streams = tuple(x.permute(2, 0, 1, 3) for x in proj.unbind(dim=3))
                stack = (*streams, randn(D, 3, H, H, scale=s), randn(D, 3, 1, H, scale=s),
                         randn(B, H, scale=0.5))
                g = randn(D, T, B, H)
                tag = f"{shape} {str(dtype).split('.')[-1]}"
                show(f"K3 fwd {tag}", lambda: K3.gru_stack_fwd(*stack, with_residuals=True))
                show(f"K3 lean {tag}", lambda: K3.gru_stack_fwd(*stack))
                h_seq, r, z, n, hnb = K3.gru_stack_fwd(*stack, with_residuals=True)
                bwd = (g, r, z, n, hnb, K2.hprev_of(h_seq, stack[5]), stack[3], dtype)
                show(f"K3 bwd {tag}", lambda: K3.gru_stack_bwd(*bwd))
    if "K6" in args.only:
        for B, T, H in K6_SHAPES:
            seq = (randn(B, T, 3 * H), randn(3 * H, H, scale=H ** -0.5),
                   randn(3 * H, scale=H ** -0.5), randn(B, H, scale=0.5))
            show(f"K6 (B={B}, T={T}, H={H}), one direction",
                 lambda: K6.gru_seq_layer(*seq, reverse=True))
    if "K1" in args.only:
        B, L, H, E, S = K1_SHAPE
        q, do = (randn(B, L, H, E).to(torch.bfloat16) for _ in range(2))
        k, v = (randn(H, S, E).to(torch.bfloat16) for _ in range(2))
        for rate in (0.0, 0.1):
            attn = (E ** -0.5, rate, 5)
            out, lse = K1.reprogramming_attention_fwd(q, k, v, *attn, with_lse=True)
            show(f"K1 fwd with lse, rate {rate}",
                 lambda: K1.reprogramming_attention_fwd(q, k, v, *attn, with_lse=True))
            show(f"K1 bwd, rate {rate}",
                 lambda: K1.reprogramming_attention_bwd(q, k, v, out, lse, do, *attn))
    if {"K4", "K5"} & set(args.only):
        for shape in ATTN_SHAPES:
            q, k, v, do = (randn(*shape).to(torch.bfloat16) for _ in range(4))
            for rate in (0.0, 0.1):
                attn = (shape[3] ** -0.5, rate, 5)
                for name, fwd, bwd in (("K4", K4.fused_attention_fwd, K4.fused_attention_bwd),
                                       ("K5", K5.block_attention_fwd, K5.block_attention_bwd)):
                    if name in args.only:
                        show(f"{name} fwd {shape}, rate {rate}", lambda: fwd(q, k, v, *attn))
                        show(f"{name} bwd {shape}, rate {rate}",
                             lambda: bwd(q, k, v, do, *attn))


if __name__ == "__main__":
    main()
