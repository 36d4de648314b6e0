"""Where a step of the one-block GRU forward (`gru_fwd_block_kernel`, the
discriminator's H = 64) spends its clocks, on the card.

  python3 hop_tpu_torch/cli/gru_step_clocks.py [--out DIR]

Run as a file from the repository root on a machine with a CUDA card and
nvcc. It copies `hop_tpu_torch/` into DIR (default `build/gru_step_clocks`,
gitignored) and changes only the copy: thread 0 of block (0, 0) reads
`clock64()` between the phases of the kernel's prologue and of every step,
a debug C entry (`hop_gru_clocks`) reads the sums back, and the copy is
built into DIR/build. Then, in a process that imports the copy, it runs
K3's forward at the discriminator's shape (D=2, T=28, B=256, H=64), lean and
with residuals, f32 and bf16 streams, and prints one line per case: the
error against the plain version, the copy's own time (torch.profiler), and
the clocks of the prologue and of a mean step by phase. Each phase's results
are forced before its clock is read (a never-taken branch on their sum), so
that the latency of an MMA or a load lands in its own phase: the copy runs
slower than the kernel (`time_kernels.py` times the kernel itself); read
the phases' shares, not the total.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (anchor in csrc/gru_common.cuh, text inserted after it), in order: each
# anchor occurs once in the text the entries before it leave
_CLOCKS = (
    ("constexpr int SM_COUNT = 132;       // an H100's\n",
     "__device__ long long hop_clk[16];\n"),
    ("gru_fwd_block_kernel(HOP_FWD_PARAMS) {\n",
     "  const long long clk_start = clock64();\n"
     "  long long ck[7] = {0, 0, 0, 0, 0, 0, 0}, pk[2] = {0, 0};\n"
     "  long long cprev = 0, clk_loop = 0;\n"
     "#define HOP_CLK(i) \\\n"
     "  { const long long x_ = clock64(); ck[i] += x_ - cprev; cprev = x_; }\n"
     "#define HOP_FORCE(v) if (__float_as_uint(v) == 0x7fc00001u) hb[0][0][0] = 0.f;\n"),
    ("        wa[gate][ks][q] = u < H && k < H ? wd[(size_t(gate) * H + k) * H + u] : 0.f;\n"
     "      }\n",
     "  pk[0] = clock64();\n"
     "  {\n"
     "    float f_ = 0.f;\n"
     "    for (int g_ = 0; g_ < 3; ++g_)\n"
     "      for (int k_ = 0; k_ < NB_KS; ++k_)\n"
     "        for (int q_ = 0; q_ < 4; ++q_) f_ += wa[g_][k_][q_];\n"
     "    HOP_FORCE(f_)\n"
     "  }\n"
     "  pk[1] = clock64();\n"),
    ("  __syncthreads();   // h0 is in place\n",
     "  clk_loop = clock64();\n"),
    ("  for (int s = 0; s < T; ++s) {\n"
     "    const int t = back ? T - 1 - s : s;\n"
     "    float vr[2], vz[2], vn[2];\n",
     "    cprev = clock64();\n"),
    ("      vn[i] = ok[i] ? to_f32(pn[i]) : 0.f;\n"
     "    }\n",
     "    HOP_FORCE(vr[0] + vz[0] + vn[0] + vr[1] + vz[1] + vn[1])\n"
     "    HOP_CLK(0)\n"),
    ("    if (s + 1 < T) load_streams(back ? T - 2 - s : s + 1);\n",
     "    HOP_CLK(1)\n"),
    ("        mma_tf32(acc[gate][2], a_hi, b_hi[0], b_hi[1]);\n"
     "      }\n"
     "    }\n",
     "    {\n"
     "      float f_ = 0.f;\n"
     "      for (int g_ = 0; g_ < 3; ++g_)\n"
     "        for (int m_ = 0; m_ < 3; ++m_) f_ += acc[g_][m_][0];\n"
     "      HOP_FORCE(f_)\n"
     "    }\n"
     "    HOP_CLK(2)\n"),
    ("        hs[gate][i] = kh == 0 ? keep[gate][i] + other : other + keep[gate][i];\n"
     "      }\n",
     "    HOP_FORCE(hs[0][0] + hs[1][1] + hs[2][0])\n"
     "    HOP_CLK(3)\n"),
    ("      if (uo < H) hb[(s + 1) & 1][re[i]][uo] = hreg[i];\n"
     "    }\n",
     "    HOP_CLK(4)\n"),
    ("          hnb_out[o] = hnb[i];\n"
     "        }\n"
     "      }\n"
     "    }\n",
     "    HOP_CLK(5)\n"),
    ("    __syncthreads();   // h_t is written and h_{t-1} and xb read by every warp\n",
     "    HOP_CLK(6)\n"),
    # the end of the kernel: the sums of block (0, 0), thread 0
    ("    HOP_CLK(6)\n"
     "  }\n",
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 7; ++i) hop_clk[i] = ck[i];\n"
     "    hop_clk[7] = clock64() - clk_start;\n"
     "    hop_clk[8] = T;\n"
     "    hop_clk[9] = pk[0] - clk_start;\n"
     "    hop_clk[10] = pk[1] - pk[0];\n"
     "    hop_clk[11] = clk_loop - pk[1];\n"
     "  }\n"),
)
STEP_PHASES = ("stream wait", "next streams' loads", "product (4 k steps x 9 MMAs)",
               "halves swapped", "gate math + h", "output stores", "block barrier")
PROLOGUE_PHASES = ("W loads issued", "W landed", "h0, bias, barriers")


def make_copy(out: str) -> None:
    """The instrumented copy of hop_tpu_torch/ under `out`."""
    dst = os.path.join(out, "hop_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "hop_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "csrc", "gru_common.cuh")
    with open(path) as f:
        src = f.read()
    for anchor, text in _CLOCKS:
        if src.count(anchor) != 1:
            sys.exit("gru_step_clocks: the kernel changed; this anchor is not found "
                     f"once:\n{anchor}")
        src = src.replace(anchor, anchor + text)
    with open(path, "w") as f:
        f.write(src)
    with open(os.path.join(dst, "csrc", "gru_stack.cu"), "a") as f:
        f.write('\nextern "C" int hop_gru_clocks(long long* out) {\n'
                "  return int(cudaMemcpyFromSymbol(out, hop_clk, sizeof(long long) * 16));\n"
                "}\n")


def run(out: str) -> None:
    """Builds the copy under `out` and prints the clocks (imports the copy)."""
    import ctypes

    root = os.path.abspath(out)
    sys.path.insert(0, root)
    os.environ["HOP_TPU_TORCH_BUILD_DIR"] = os.path.join(root, "build")
    import torch

    from hop_tpu_torch.cli.time_kernels import kernel_ms_by_name
    from hop_tpu_torch.ops import _build
    from hop_tpu_torch.ops import gru_stack as K3
    if not os.path.abspath(K3.__file__).startswith(root + os.sep):
        sys.exit(f"gru_step_clocks: hop_tpu_torch came from {K3.__file__}, not {root}")
    _build.SIGNATURES["hop_gru_clocks"] = [ctypes.c_void_p]
    lib = _build.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{smi}; the instrumented copy in {root}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    D, T, B, H = 2, 28, 256, 64
    for dtype in (torch.float32, torch.bfloat16):
        proj = torch.randn(T, B, D, 3, H, device=dev, generator=gen).to(dtype)
        streams = tuple(x.permute(2, 0, 1, 3) for x in proj.unbind(dim=3))
        args = (*streams, torch.randn(D, 3, H, H, device=dev, generator=gen) * H ** -0.5,
                torch.randn(D, 3, 1, H, device=dev, generator=gen) * 0.1,
                torch.randn(B, H, device=dev, generator=gen) * 0.5)
        for res in (False, True):
            def fn():
                return K3.gru_stack_fwd(*args, with_residuals=res)
            got, want = fn(), K3.plain_gru_stack(*args, with_residuals=res)
            torch.cuda.synchronize()
            if not res:
                got, want = (got,), (want,)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            buf = (ctypes.c_longlong * 16)()
            _build.check(lib.hop_gru_clocks(buf), "hop_gru_clocks")
            own = sum(kernel_ms_by_name(fn).values())
            step = [buf[i] / buf[8] for i in range(len(STEP_PHASES))]
            print(f"(D={D}, T={T}, B={B}, H={H}) {str(dtype).split('.')[-1]} "
                  f"{'with residuals' if res else 'lean'}: max_abs_err {err:.2e}; "
                  f"the copy's own time {own:.4f} ms; block (0, 0) {buf[7]} clocks: "
                  "prologue " + ", ".join(f"{n} {buf[9 + i]}"
                                          for i, n in enumerate(PROLOGUE_PHASES))
                  + f"; a step {sum(step):.0f}: "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(STEP_PHASES, step)),
                  flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "gru_step_clocks"),
                        help="directory of the instrumented copy")
    parser.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.run:
        run(args.out)
        return
    make_copy(args.out)
    # a fresh process, so that it imports the copy and nothing of this checkout
    subprocess.run([sys.executable, os.path.abspath(__file__), "--out", args.out, "--run"],
                   check=True)


if __name__ == "__main__":
    main()
