"""A dry run of the parallel path on the CPU (the counterpart of
`__graft_entry__.dryrun_multichip`, __graft_entry__.py:53-130):

    python -m hop_tpu_torch.parallel.dryrun [--ranks 8] [--timeout 600]

launches `--ranks` gloo processes on this machine (one thread each; 8 by
default) and, on one process group, runs two legs: the data = 4 x model = 2
layout, then dcn = 2 x data = 2 x model = 2 (with fewer ranks: data = N/2 x
model = 2, and no second leg). Each leg takes one full HOP GAN step at the
tiny size on a global batch of twice the batch group, ZeRO on, the frozen
backbone sharded over the model axis, then the validation pass on that
batch split over the batch group, and rank 0 prints the step's loss and the
pass's FGD. hop_tpu's run of the same legs draws with JAX's generators, so
its readings are not targets for these.
"""

from __future__ import annotations

import argparse
import sys


def leg(degrees: tuple, seed: int = 2021) -> str:
    import torch
    from hop_tpu_torch.cli.common import device_batch
    from hop_tpu_torch.cli.train_main import generate_from_state
    from hop_tpu_torch.config import tiny_test_config
    from hop_tpu_torch.data.synthetic import make_host_batch
    from hop_tpu_torch.eval.evaluate import evaluate_testset
    from hop_tpu_torch.eval.fgd import EmbeddingSpaceEvaluator, make_ted_feature_fn
    from hop_tpu_torch.models.embedding_net import EmbeddingNet
    from hop_tpu_torch.models.hop import build_hop_model
    from hop_tpu_torch.models.multimodal_context import build_discriminator
    from hop_tpu_torch.parallel import attach_batch_group, batch_rows
    from hop_tpu_torch.parallel.mesh import make_mesh
    from hop_tpu_torch.train.llm import make_hop_train_steps

    cfg = tiny_test_config("TED")
    mesh = make_mesh(degrees, "cpu")
    B = max(2 * mesh.batch_size, 2)
    model = build_hop_model(cfg, 10, seed, "cpu", mesh)
    disc = build_discriminator(cfg, seed + 1, "cpu")
    attach_batch_group(model, mesh)
    attach_batch_group(disc, mesh)
    _, gan, init_state = make_hop_train_steps(cfg, model, disc, mesh)
    host = make_host_batch(cfg, B, seed=0)
    state, metrics = gan(init_state(), device_batch(batch_rows(host, mesh), cfg, device="cpu"),
                         torch.Generator().manual_seed(7))
    loss = float(metrics["loss"])

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = EmbeddingNet(pose_dim=cfg.data.pose_dim, n_frames=cfg.data.n_poses,
                           n_words=50, mode="pose").eval()
    r = evaluate_testset([device_batch(host, cfg, device="cpu")],
                         lambda b, vids, g: generate_from_state(cfg, state, b, vids, g),
                         EmbeddingSpaceEvaluator(make_ted_feature_fn(net), trained=False),
                         epoch=99, cfg=cfg, n_speakers=10,
                         generator=torch.Generator().manual_seed(11), mesh=mesh)
    assert torch.isfinite(torch.tensor([loss, r.frechet_dist])).all(), (loss, r)
    shape = dict(zip(("dcn", "data", "model"), degrees))
    if shape["dcn"] == 1:
        del shape["dcn"]
    return f"dryrun_multichip ok: mesh={shape} loss={loss:.4f} eval_fgd={r.frechet_dist:.4f}"


def rank_main() -> None:
    import torch
    from hop_tpu_torch.parallel.mesh import destroy, init_distributed
    torch.set_num_threads(1)
    mesh = init_distributed("cpu")
    world = mesh.world
    legs = [(1, world // 2, 2)] + ([(2, world // 4, 2)] if world >= 8 else [])
    for degrees in legs:
        line = leg(degrees)
        if mesh.is_main:
            print(line, flush=True)
    destroy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank:
        rank_main()
        return
    if args.ranks < 4 or args.ranks % 2:
        raise SystemExit("--ranks: an even number, at least 4 (model = 2)")
    from hop_tpu_torch.parallel.local import check_ranks, run_ranks
    print(check_ranks(run_ranks(["-m", "hop_tpu_torch.parallel.dryrun", "--rank"],
                                args.ranks, args.timeout)), end="")


if __name__ == "__main__":
    main(sys.argv[1:])
