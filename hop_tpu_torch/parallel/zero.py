"""Adam on a rank of a parallel run, with the ZeRO-2 analog (port of
hop_tpu's `shard_opt_state` / `shard_state(zero2=True)`, parallel/mesh.py;
the reference's DeepSpeed ZeRO-2 plugin, run_ted.py:110-112).

`RankAdam.step()` first reduces the gradients over the batch group
(`collectives.sync_grads`: averaged, or summed for a loss that sums over
the batch), then runs torch's Adam. With ZeRO (`Mesh.zero2`, on where the
data axis has more than one rank) each data rank holds and updates only its
share of Adam's moments: every moment is cut along the axis `zero2_spec`
names, the first one the data axis divides, and a tensor no axis of which
it divides stays whole on every rank, as in hop_tpu. The rank's Adam runs
over views of its rows of each parameter; after the step each data rank
broadcasts its updated rows (one flat buffer a rank), so the parameters
are whole again on every rank. Adam is elementwise, so the parameters after
a step are bit for bit those of the unsharded optimizer given the same
gradients.

`state_dict()` gathers the moments (a broadcast from each data rank, every
rank taking part) into the one-process format of `torch.optim.Adam`, so a
checkpoint written at any world size loads at any other; `load_state_dict`
takes that format and keeps this rank's share.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist

from hop_tpu_torch.parallel.collectives import sync_grads
from hop_tpu_torch.parallel.mesh import Mesh, zero2_spec

MOMENTS = ("exp_avg", "exp_avg_sq")


class RankAdam:
    """torch.optim.Adam's interface (`step`, `zero_grad`, `state_dict`,
    `load_state_dict`) for one rank of `mesh`."""

    def __init__(self, params, lr: float, betas, eps: float, mesh: Mesh,
                 op: str = "mean"):
        self.params = list(params)
        self.mesh, self.op = mesh, op
        self.zero = mesh.zero2 and mesh.n_data > 1
        n, r = mesh.n_data, mesh.data_rank
        self.axes = [zero2_spec(p.shape, n) if self.zero else None for p in self.params]
        self._shards = [p if ax is None else self._rows(p.detach(), ax, r)
                        for p, ax in zip(self.params, self.axes)]
        self.inner = torch.optim.Adam(self._shards, lr=lr, betas=tuple(betas), eps=eps)
        self._synced = False

    def _rows(self, t: torch.Tensor, ax: int, r: int) -> torch.Tensor:
        k = t.shape[ax] // self.mesh.n_data
        return t.narrow(ax, r * k, k)

    def sync_grads(self) -> None:
        """The gradients reduced over the batch group, once a step (a caller
        that reads them before `step`, such as a global-norm clip, calls it
        first)."""
        if not self._synced:
            sync_grads(self.params, self.mesh.batch_group, self.op)
            self._synced = True

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, s in zip(self.params, self._shards):
            p.grad = None
            s.grad = None

    def step(self) -> None:
        self.sync_grads()
        self._synced = False
        if not self.zero:
            self.inner.step()
            return
        r = self.mesh.data_rank
        stepped = []
        for i, (p, s, ax) in enumerate(zip(self.params, self._shards, self.axes)):
            if ax is not None:
                s.grad = None if p.grad is None else self._rows(p.grad, ax, r)
                if p.grad is not None:
                    stepped.append(i)
        self.inner.step()
        self._exchange([[self.params[i].data] for i in stepped], [self.axes[i] for i in stepped])

    def _exchange(self, tensors: list, axes: list) -> None:
        """Each data rank's rows of every tensor of `tensors` (lists of
        whole tensors, cut along the matching axis of `axes`) broadcast from
        it into every rank's copy, one flat buffer a rank."""
        if not tensors:
            return
        me = self.mesh.data_rank
        for r, src in enumerate(self.mesh.data_ranks()):
            views = [self._rows(t, ax, r) for ts, ax in zip(tensors, axes) for t in ts]
            if r == me:
                flat = torch.cat([v.reshape(-1) for v in views])
            else:
                flat = torch.empty(sum(v.numel() for v in views), dtype=views[0].dtype,
                                   device=views[0].device)
            dist.broadcast(flat, src=src, group=self.mesh.data_group)
            if r != me:
                for v, piece in zip(views, flat.split([v.numel() for v in views])):
                    v.copy_(piece.view(v.shape))

    def state_dict(self) -> dict:
        """torch.optim.Adam's state_dict of the whole parameters (every rank
        takes part; each returns the same)."""
        sd = self.inner.state_dict()
        if not self.zero:
            return sd
        sd = {"state": {i: dict(s) for i, s in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        sharded = sorted(i for i in sd["state"] if self.axes[i] is not None)
        whole = {}
        for i in sharded:
            p, ax, r = self.params[i], self.axes[i], self.mesh.data_rank
            for key in MOMENTS:
                full = torch.empty(p.shape, dtype=sd["state"][i][key].dtype, device=p.device)
                self._rows(full, ax, r).copy_(sd["state"][i][key])
                whole[(i, key)] = full
        self._exchange([[whole[(i, k)] for k in MOMENTS] for i in sharded],
                       [self.axes[i] for i in sharded])
        for (i, key), full in whole.items():
            sd["state"][i][key] = full
        return sd

    def load_state_dict(self, saved: dict) -> None:
        """Adam's state_dict of the whole parameters (from any world size);
        this rank keeps its share of the moments."""
        saved = copy.copy(saved)
        if self.zero:
            r = self.mesh.data_rank
            saved["state"] = {
                i: {k: (self._rows(v, self.axes[int(i)], r).clone()
                        if k in MOMENTS and self.axes[int(i)] is not None else v)
                    for k, v in s.items()}
                for i, s in saved["state"].items()}
        self.inner.load_state_dict(saved)


def rank_adam(params, lr: float, betas, mesh: Optional[Mesh], op: str = "mean"):
    """torch.optim.Adam over `params` for a one-process run (`mesh` None),
    else a `RankAdam`."""
    if mesh is None:
        return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)
    return RankAdam(params, lr, betas, 1e-8, mesh, op)
