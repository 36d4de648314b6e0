"""The rank layout of a parallel run (port of hop_tpu/parallel/mesh.py).

`hop_tpu` runs one program over a `jax.sharding.Mesh` of devices with axes
(dcn, data, model): the batch is sharded over dcn x data, the frozen
backbone's kernels over model, and XLA inserts the collectives. The port
runs one process per rank, launched by torchrun, and each rank places its
tensors itself. A `Mesh` here is a value the caller passes down (to the
steps, the model builders, the validation pass and the loop), never
context: it holds the (dcn, data, model) coordinates of every rank, in
`create_mesh`'s order (`np.arange(world).reshape(n_dcn, n_data, n_model)`:
dcn outermost, model innermost), and this rank's three process groups:

  * batch: the ranks of this model coordinate over dcn x data. The batch is
    split over it and gradients, batch statistics and logged metrics are
    reduced over it;
  * data: the ranks of this slice and model coordinate. ZeRO shards Adam's
    moments over it, so that moment traffic stays inside a slice
    (hop_tpu's mesh.py:33-38);
  * model: the ranks of this (dcn, data) cell, the backbone's tensor
    parallelism (`models/bert.py`, `models/llama.py`).

hop_tpu's `constrain_batch`, `ambient_mesh` and `state_shardings` have no
counterpart: they steer XLA's sharding propagation, and the port's rank
code places every tensor explicitly.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: the batch field that keeps the GLOBAL batch's speaker ids on every rank:
#: the diversity regulariser's permutation indexes the whole batch
GLOBAL_VIDS = "vid_indices_global"
#: how long a collective may wait before the process group gives up
DIST_TIMEOUT = datetime.timedelta(seconds=600)


def torchrun_command(argv_tail: str = "-m hop_tpu_torch.cli.run_ted ...") -> str:
    return f"python -m torch.distributed.run --nproc-per-node N {argv_tail}"


def layout(n_dcn: int, n_data: int, n_model: int) -> np.ndarray:
    """(n_dcn, n_data, n_model) array of the ranks at each coordinate, as
    `create_mesh` reshapes its devices."""
    return np.arange(n_dcn * n_data * n_model).reshape(n_dcn, n_data, n_model)


def resolve_degrees(world: int, data_parallel: int = 0, model_parallel: int = 1,
                    dcn_slices: int = 1) -> tuple:
    """(n_dcn, n_data, n_model) for a run of `world` ranks. `data_parallel`
    0 means world / (model x dcn) (hop_tpu's train_main.py:326-330). A
    product that is not `world` is refused with the numbers."""
    n_model, n_dcn = max(model_parallel, 1), max(dcn_slices, 1)
    n_data = data_parallel or world // (n_model * n_dcn)
    if n_data < 1 or n_dcn * n_data * n_model != world:
        raise SystemExit(
            f"--dcn-slices {n_dcn} x --data-parallel {data_parallel or n_data} x "
            f"--model-parallel {n_model} = {n_dcn * max(n_data, 0) * n_model} ranks, "
            f"but WORLD_SIZE is {world}: launch as many processes as the mesh has "
            f"ranks ({torchrun_command()})")
    return n_dcn, n_data, n_model


@dataclass
class Mesh:
    """This rank's place in an (n_dcn, n_data, n_model) layout and its
    process groups (None where the run has one process)."""
    n_dcn: int
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str = "gloo"
    zero2: bool = False
    batch_group: Optional[object] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.n_dcn * self.n_data * self.n_model

    @property
    def coords(self) -> tuple:
        """(dcn, data, model) of this rank."""
        d, rest = divmod(self.rank, self.n_data * self.n_model)
        return (d, *divmod(rest, self.n_model))

    @property
    def batch_size(self) -> int:
        """Ranks over which the batch is split (dcn x data)."""
        return self.n_dcn * self.n_data

    @property
    def batch_rank(self) -> int:
        """This rank's block of rows of the global batch."""
        d, a, _ = self.coords
        return d * self.n_data + a

    @property
    def data_rank(self) -> int:
        return self.coords[1]

    @property
    def model_rank(self) -> int:
        return self.coords[2]

    def batch_ranks(self) -> list:
        return layout(self.n_dcn, self.n_data, self.n_model)[..., self.model_rank].ravel().tolist()

    def data_ranks(self) -> list:
        d, _, m = self.coords
        return layout(self.n_dcn, self.n_data, self.n_model)[d, :, m].tolist()

    def model_ranks(self) -> list:
        d, a, _ = self.coords
        return layout(self.n_dcn, self.n_data, self.n_model)[d, a, :].tolist()

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files."""
        return self.rank == 0

    def rows(self, local_batch: int) -> slice:
        """This rank's rows of a global batch of `local_batch x batch_size`."""
        return slice(self.batch_rank * local_batch, (self.batch_rank + 1) * local_batch)

    def describe(self) -> str:
        """hop_tpu's line (train_main.py:338-342)."""
        axes = f"data={self.n_data} x model={self.n_model}"
        if self.n_dcn > 1:
            axes = f"dcn={self.n_dcn} x " + axes
        return f"mesh: {axes}" + (" (zero2 opt-state sharding)" if self.zero2 else "")


def zero2_spec(shape, n_data: int) -> Optional[int]:
    """The axis along which ZeRO shards an optimizer moment of `shape` over
    `n_data` data ranks: the first one that `n_data` divides (hop_tpu's
    `zero2_spec`, whose PartitionSpec names 'data' at this axis); None keeps
    the moment whole on every rank."""
    for ax, d in enumerate(shape):
        if d >= n_data and d % n_data == 0:
            return ax
    return None


def wants_ranks(data_parallel: int = 0, model_parallel: int = 1, dcn_slices: int = 1) -> bool:
    """Whether the flags ask for more than one rank, or torchrun launched
    more than one."""
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1 or data_parallel > 1
            or model_parallel > 1 or dcn_slices > 1)


def init_distributed(device, data_parallel: int = 0, model_parallel: int = 1,
                     dcn_slices: int = 1, zero2: bool = True,
                     backend: Optional[str] = None) -> Mesh:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and build this rank's
    `Mesh`. The backend is NCCL on the card, this rank on `cuda:LOCAL_RANK`
    (a device given with its index keeps it), and gloo on the CPU; an
    explicit `backend` overrides the choice (gloo puts two ranks on one
    card, which NCCL refuses). Without torchrun's environment a request for
    more than one rank is refused with the command line. ZeRO (`zero2`)
    holds only where the data axis has more than one rank (hop_tpu's
    train_main.py:336-337)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            "a parallel run (--data-parallel, --model-parallel or --dcn-slices above "
            "1) runs one process a rank, launched by torchrun: "
            + torchrun_command("-m hop_tpu_torch.cli.run_ted --data-parallel N ..."))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n_dcn, n_data, n_model = resolve_degrees(world, data_parallel, model_parallel,
                                             dcn_slices)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        if device.index >= torch.cuda.device_count():
            raise SystemExit(f"rank {rank} wants {device}, but this machine has "
                             f"{torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=DIST_TIMEOUT)
    return make_mesh((n_dcn, n_data, n_model), device, zero2)


def make_mesh(degrees: tuple, device, zero2: bool = True) -> Mesh:
    """This rank's `Mesh` of (n_dcn, n_data, n_model) over the joined
    process group (every rank calls it alike: it creates every group of the
    layout, in one order). A second call makes another layout over the same
    ranks."""
    n_dcn, n_data, n_model = degrees
    rank = dist.get_rank()
    mesh = Mesh(n_dcn, n_data, n_model, rank, torch.device(device),
                dist.get_backend(), zero2=zero2 and n_data > 1)
    grid = layout(n_dcn, n_data, n_model)
    # every rank creates every group, in one order
    for name, groups in (("batch_group", [grid[..., m].ravel() for m in range(n_model)]),
                         ("data_group", [grid[d, :, m] for d in range(n_dcn)
                                         for m in range(n_model)]),
                         ("model_group", [grid[d, a, :] for d in range(n_dcn)
                                          for a in range(n_data)])):
        for ranks in groups:
            group = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                setattr(mesh, name, group)
    return mesh


def batch_rows(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This rank's contiguous rows of a host batch (numpy arrays) that every
    rank built alike (hop_tpu's `batch_sharding` + `shard_batch`), before
    `device_batch` moves them; the global speaker ids stay beside them
    (`GLOBAL_VIDS`). A global batch the batch group does not divide is
    refused."""
    if mesh is None or mesh.batch_size == 1:
        return batch
    B = len(next(iter(batch.values())))
    if B % mesh.batch_size:
        raise SystemExit(f"global batch {B} is not divisible by the {mesh.batch_size} "
                         "ranks of the batch group (dcn x data): choose --batch-size "
                         "as a multiple")
    rows = mesh.rows(B // mesh.batch_size)
    out = {k: v[rows] for k, v in batch.items()}
    if "vid_indices" in batch:
        out[GLOBAL_VIDS] = batch["vid_indices"]
    return out


def destroy() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
