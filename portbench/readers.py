"""Helpers the per-layer metric readers (`portbench/metrics/*.py`) share.

A reader is `read(ctx) -> float | None`. `ctx` holds: `kind` (the traffic's
kind) and its `driver`, `conf`, `traffic`, `batch`, `spans` (host seconds of
the window's spans by name: "device_batch", "step", "forward"), `units` and
`window_s` (steps or calls, and seconds, of the measured window), `trace`
(a `trace.Trace` of the stretch traced on the device alone, or None) with
`traced_units`, and `host_trace` (of the stretch traced on host and
device, with the host's ranges) with `host_traced_units`. A reader that
finds nothing to read returns None and the metric is left out.
"""

from __future__ import annotations

from portbench import peaks, work

K1_KERNELS = ("reprog_attn_",)
K2_KERNELS = ("gru_proj_kernel", "gru_fwd_cluster_kernel", "gru_fwd_block_kernel",
              "gru_bwd_resident_kernel", "gru_mma_gemm_kernel", "gru_splitk_reduce_kernel",
              "gru_colsum_kernel")


def names(patterns):
    return lambda name: any(p in name for p in patterns)


def span_ms(ctx, name: str):
    values = ctx.spans.get(name)
    if not values:
        return None
    return 1e3 * sum(values) / len(values)


def roofline(ctx, kind: str, launches, patterns, flops_peak: float):
    """100 x the sum of the launches' least times (operations at
    `flops_peak`, bytes at HBM bandwidth, the larger) over the device time
    of the kernels whose names hold one of `patterns`, in the traced
    stretch of a `kind` cell."""
    if ctx.kind != kind or ctx.trace is None:
        return None
    seconds = ctx.trace.device_seconds(names(patterns))
    if seconds <= 0.0:
        return None
    bound = sum(max(f / flops_peak, b / peaks.HBM_BYTES) for _, f, b in launches)
    return 100.0 * bound * ctx.traced_units / seconds


def k1(ctx, kind: str):
    return roofline(ctx, kind, work.k1_launches(ctx.conf, ctx.batch, kind == "train_gan"),
                    K1_KERNELS, peaks.BF16_FLOPS)


def k2(ctx, kind: str):
    return roofline(ctx, kind, work.k2_launches(ctx.conf, ctx.batch, kind == "train_gan"),
                    K2_KERNELS, peaks.TF32X3_FLOPS)


def idle(ctx, kind: str):
    if ctx.kind != kind or ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx, kind: str):
    if ctx.kind != kind or not ctx.units or not ctx.window_s:
        return None
    per_unit = (work.train_step_flops if kind == "train_gan" else work.generate_flops)(
        ctx.conf, ctx.batch)
    return 100.0 * per_unit * ctx.units / (ctx.window_s * peaks.BF16_FLOPS)
