"""Collectives of a parallel run, on `torch.distributed`, autograd-aware
where a forward reads them.

`hop_tpu` writes no collective: XLA inserts psums where a sharded program
needs them. The port's ranks call these in their place:

  * `copy_to_group` (identity forward, all-reduce backward) and
    `reduce_from_group` (all-reduce forward, identity backward): Megatron's
    pair around a tensor-parallel block (`models/bert.py`, `models/llama.py`);
  * `sum_over_group` (all-reduce forward AND backward): a sum that every
    rank's loss reads, such as BatchNorm's batch statistics over the batch
    group; each rank's loss differs, so the gradient of the sum is the sum
    of every rank's;
  * `gather_rows`: the ranks' blocks of rows in rank order, the same on every
    rank; its backward returns this rank's rows of the summed gradient;
  * `sync_grads`: one flat, fixed-order, bucketed all-reduce of a net's
    gradients between a backward and the optimizer's step, averaged (or
    summed, for a loss that sums over the batch);
  * `reduce_metrics`: a step's logged scalars over the batch group.

Every function takes the group as an argument and does nothing where the
group is None. gloo takes CUDA tensors for all-reduce and broadcast but not
for all-gather, so a gather on the card over gloo is a broadcast from each
rank in turn (bit for bit what an all-gather gives).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

#: elements of one all-reduce of `sync_grads` (64 MiB of f32)
BUCKET_ELEMENTS = 1 << 24


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_index(group) -> int:
    """This rank's place in `group`'s rank order (0 where group is None)."""
    return 0 if group is None else dist.get_process_group_ranks(group).index(dist.get_rank())


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    ranks = dist.get_process_group_ranks(group)
    if x.device.type == "cpu" or dist.get_backend(group) == "nccl":
        parts = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(parts, x, group=group)
    else:
        me = dist.get_rank()
        parts = []
        for r in ranks:
            buf = x.clone() if r == me else torch.empty_like(x)
            dist.broadcast(buf, src=r, group=group)
            parts.append(buf)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n, ctx.index = group, x.shape[0], group_index(group)
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad, ctx.group)
        return total[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOverGroup.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's (n, ...) blocks as one (n * size, ...) tensor, in rank
    order; with autograd where x requires grad."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, group)
    return _gather(x, group)


def _buckets(tensors: list, limit: int):
    bucket, n = [], 0
    for t in tensors:
        if bucket and (n + t.numel() > limit or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, n = [], 0
        bucket.append(t)
        n += t.numel()
    if bucket:
        yield bucket


def flat_all_reduce(tensors: list, group, average: bool = False,
                    limit: int = BUCKET_ELEMENTS) -> None:
    """All-reduce `tensors` in place, in their order, a bucket of them in one
    flat buffer at a time; divided by the group's size with `average`."""
    n = group_size(group)
    for bucket in _buckets(tensors, limit):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        if average:
            flat.div_(n)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view_as(t))


def sync_grads(params: Iterable[torch.Tensor], group, op: str = "mean") -> None:
    """The gradients of `params` reduced over `group` (`op` "mean" or "sum"),
    in parameter order. A parameter without a gradient is left out; the
    ranks run one program, so every rank leaves out the same ones."""
    if group is None or (group_size(group) == 1 and dist.get_backend(group) != "nccl"):
        return          # a one-rank gloo group would only copy them to the host and back
    flat_all_reduce([p.grad for p in params if p.grad is not None], group,
                    average=(op == "mean"))


def reduce_metrics(metrics: dict, group, op: str = "mean") -> dict:
    """A step's detached scalars reduced over `group`, in one all-reduce."""
    if group is None or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    if op == "mean":
        flat = flat / group_size(group)
    return dict(zip(keys, flat.unbind()))


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def global_mean_var(x: torch.Tensor, dims: list, group: Optional[object],
                    centered: bool = False):
    """The mean and the biased variance of x over `dims` on every rank's
    rows together (one all-reduce of the sums, or two about the mean with
    `centered`), with autograd through the sums."""
    n = x.numel() // x.shape[1] * group_size(group)
    if centered:
        mean = sum_over_group(x.sum(dims), group) / n
        shape = [1, -1] + [1] * (x.dim() - 2)
        dev = x - mean.reshape(shape)
        return mean, sum_over_group((dev * dev).sum(dims), group) / n
    sums = sum_over_group(torch.stack([x.sum(dims), (x * x).sum(dims)]), group) / n
    mean = sums[0]
    return mean, torch.clamp(sums[1] - mean * mean, min=0.0)
