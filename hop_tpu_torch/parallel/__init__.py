"""The parallel path (port of hop_tpu/parallel): the rank layout and its
process groups (`mesh`), the collectives (`collectives`), Adam with the
ZeRO-2 analog (`zero`), and what attaches a mesh to the nets
(`attach_batch_group`)."""

from hop_tpu_torch.parallel.mesh import (  # noqa: F401
    GLOBAL_VIDS, Mesh, batch_rows, init_distributed, layout, resolve_degrees,
    wants_ranks, zero2_spec)


def attach_batch_group(net, mesh) -> None:
    """Every normalisation by batch statistics in `net` (the port's
    BatchNorm classes and seq2seq's `BatchStatNorm`, which read the
    attribute `batch_group`) takes its statistics over the batch group of
    `mesh`, where the batch is split over more than one rank."""
    if mesh is None or mesh.batch_size == 1:
        return
    for m in net.modules():
        if hasattr(m, "batch_group"):
            m.batch_group = mesh.batch_group
