"""Build and load the port's CUDA kernels.

At first use, every `hop_tpu_torch/csrc/*.cu` is compiled by nvcc for
sm_90a, one nvcc process per source, all started together, and the
objects are linked into one shared library with a plain C interface,
loaded with ctypes. The library's file name carries a hash of the sources and flags,
so an edited kernel is rebuilt and an unchanged one is loaded as built.
The build directory is `build/kernels/` at the repository root (listed in
.gitignore), or `$HOP_TPU_TORCH_BUILD_DIR`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises on anything but cudaSuccess. There
is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_longlong
# C signatures of the entry points in csrc/, name -> argtypes
SIGNATURES = {
    # q, k, v, out, lse (or NULL), part_o, part_ml (workspaces of the key
    # splits, or NULL), n_split, B, L, H, S, scale, seed, thresh, inv_keep,
    # stream
    "hop_reprog_attn_fwd": [_P] * 7 + [_I] * 5 + [_F, _U, _U, _F, _P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, part (workspace of the row
    # runs, or NULL), n_runs, B, L, H, S, scale, seed, thresh, inv_keep, stream
    "hop_reprog_attn_bwd": [_P] * 11 + [_I] * 5 + [_F, _U, _U, _F, _P],
    # x, wih, bih, whh, bhh, h0, xp (workspace), out, r, z, n, hnb (residuals
    # or NULL), T, B, I, H, D, stream
    "hop_gru_fused_fwd": [_P] * 12 + [_I] * 5 + [_P],
    # H -> the recurrence kernel at this H, forward and backward: 0 one
    # block, 1 a cluster (negative: minus a CUDA error)
    "hop_gru_recurrence_variant": [_I],
    # B, D -> batch rows of a forward cluster
    "hop_gru_fwd_cluster_rows": [_I, _I],
    # H, backward flag -> clusters of the wide recurrence the card holds at
    # once (0: a narrow layer, no clusters; negative: minus a CUDA error)
    "hop_gru_active_clusters": [_I, _I],
    # g, x, r, z, n, hnb, hprev, wih, whh, d_in, d_hid, work, dx, dwih,
    # dbih, dwhh, dbhh, dh0, T, B, I, H, D, stream
    "hop_gru_fused_bwd": [_P] * 18 + [_I] * 5 + [_P],
    # T, B, I, H, D -> floats of workspace hop_gru_fused_bwd needs
    "hop_gru_fused_bwd_workspace": [_I] * 5,
    # xr, xz, xn, their strides of D, T and B (elements), bf16 flag, w, b,
    # h0, out, r, z, n, hnb (residuals or NULL), T, B, H, D, stream
    "hop_gru_stack_fwd": [_P] * 3 + [_L] * 3 + [_I] + [_P] * 8 + [_I] * 4 + [_P],
    # g, r, z, n, hnb, hprev, w, dx, bf16 flag, d_hid, work, dw, db, dh0,
    # T, B, H, D, stream
    "hop_gru_stack_bwd": [_P] * 8 + [_I] + [_P] * 5 + [_I] * 4 + [_P],
    # T, B, H, D -> floats of workspace hop_gru_stack_bwd needs
    "hop_gru_stack_bwd_workspace": [_I] * 4,
    # x_proj, w_t, b_hh, h0, out, T, B, H, reverse, stream
    "hop_gru_seq_fwd": [_P] * 5 + [_I] * 4 + [_P],
    # q, k, v, out, B, T, H, scale, seed, thresh, inv_keep, stream
    "hop_attn_fwd": [_P] * 4 + [_I] * 3 + [_F, _U, _U, _F, _P],
    # q, k, v, dout, dq, dk, dv, B, T, H, scale, seed, thresh, inv_keep, stream
    "hop_attn_bwd": [_P] * 7 + [_I] * 3 + [_F, _U, _U, _F, _P],
    # q, k, v, out, B, T, H, nb, scale, seed, thresh, inv_keep, stream
    "hop_block_attn_fwd": [_P] * 4 + [_I] * 4 + [_F, _U, _U, _F, _P],
    # q, k, v, dout, dq, dk, dv, B, T, H, nb, scale, seed, thresh, inv_keep,
    # stream
    "hop_block_attn_bwd": [_P] * 7 + [_I] * 4 + [_F, _U, _U, _F, _P],
}
# return types other than int (a CUDA error code)
RESTYPES = {"hop_gru_fused_bwd_workspace": ctypes.c_longlong,
            "hop_gru_stack_bwd_workspace": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build (or load) that made _lib
ptxas_log = ""         # nvcc's -Xptxas -v report of the last build


def _build_dir() -> Path:
    env = os.environ.get("HOP_TPU_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of hop_tpu_torch cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _build_dir() / f"libhop_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The kernels' library, built first if it is not there yet."""
    global _lib, build_seconds, ptxas_log
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tag = f"{out.stem}.{os.getpid()}"
            nvcc = _nvcc()
            jobs = []
            for src in _sources():
                obj = out.parent / f"{tag}.{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            logs = []
            for cmd, _, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{err}")
                logs.append(err)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            ptxas_log = "".join(logs)
            os.replace(tmp, out)
            for _, obj, _ in jobs:
                obj.unlink()
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_device(t, name: str) -> None:
    """A public kernel function takes CPU tensors (the plain version) or
    CUDA tensors (the kernel); anything else has no kernel. (A registered
    operator's fake implementation serves tracing, on fake tensors of
    those two devices, and never reaches a launch.)"""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
