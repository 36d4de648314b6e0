"""Train the FGD gesture autoencoder on Human3.6M (port of
hop_tpu/cli/train_h36m_ae.py).

The reference's TED FGD feature net was trained on Human3.6M windows
(checkpoint dir `train_h36m_gesture_autoencoder`, run_ted.py:126; the
loader data_loader/h36m_loader.py). This entry point takes the same path:
the reference's `data_3d_h36m.npz` (a pickled `positions_3d` dict of
{subject: {action: (frames, 32, 3)}}, read with numpy) -> `data.h36m.
Human36M` windows (12 joints, frontalised, noise-augmented) ->
EmbeddingNet(mode="pose") at TED's width (pose_dim 27) -> a checkpoint of
the port's `CheckpointManager`, which `eval.export_eval_net` turns into an
`--eval-net` .npz. (The Expressive feature net cannot come from H36M: train
it with `run_expressive --model gesture_autoencoder`.)

Each epoch shuffles the windows with seed + epoch, steps on whole batches
(a step's draws from `utils.prng.step_generator`), then measures the
reconstruction L1 of up to 512 test-subject windows; the best epoch is
saved. On the card (the default) cuDNN runs deterministic, in f32.

Usage:
  python -m hop_tpu_torch.cli.train_h36m_ae --npz data_3d_h36m.npz \
      --checkpoint-dir ./ck_h36m [--epochs 40] [--device cpu]
  python -m hop_tpu_torch.eval.export_eval_net --checkpoint-dir ./ck_h36m \
      --out evalnet.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from hop_tpu_torch.cli.train_main import deterministic_cudnn
from hop_tpu_torch.config import ted_config
from hop_tpu_torch.data.h36m import Human36M
from hop_tpu_torch.models.embedding_net import build_embedding_net
from hop_tpu_torch.train.embed import make_embed_train_step
from hop_tpu_torch.utils.checkpoint import CheckpointManager
from hop_tpu_torch.utils.prng import step_generator


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--npz", required=True,
                   help="h36m positions npz (reference h36m_loader.py:31 format: "
                        "positions_3d item dict)")
    p.add_argument("--dataset", default="TED", choices=("TED",),
                   help="H36M windows carry the 10-joint TED skeleton; the "
                        "Expressive (43-joint) FGD net cannot be trained from them: "
                        "use run_expressive --model gesture_autoencoder")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=5e-4)
    p.add_argument("--checkpoint-dir", default="./ck_h36m")
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--augment", action=argparse.BooleanOptionalAction, default=True,
                   help="h36m noise augmentation (h36m_loader.py:84-90); "
                        "--no-augment disables")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    deterministic_cudnn(device)
    cfg = ted_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, learning_rate=args.learning_rate, batch_size=args.batch_size))
    d = cfg.data
    skel = d.skeleton
    with np.load(args.npz, allow_pickle=True) as payload:
        positions = payload["positions_3d"].item()
    train_ds = Human36M(positions, skel.mean_dir_vec, is_train=True, augment=args.augment,
                        n_poses=d.n_poses, skeleton=skel, seed=args.seed)
    val_ds = Human36M(positions, skel.mean_dir_vec, is_train=False, augment=False,
                      n_poses=d.n_poses, skeleton=skel, seed=args.seed)
    print(f"h36m windows: train {len(train_ds)}, val {len(val_ds)}")

    net = build_embedding_net(cfg, 4, "pose", args.seed, device)
    step, init_state = make_embed_train_step(cfg, net, mode="pose")
    state = init_state()
    ckpt = CheckpointManager(args.checkpoint_dir)
    ckpt.metadata = {"model": "gesture_autoencoder", "source": "h36m",
                     "dataset": d.dataset}

    def batches(epoch):
        order = np.random.default_rng(args.seed + epoch).permutation(len(train_ds))
        for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
            vecs = np.stack([train_ds[j][1] for j in order[i:i + args.batch_size]])
            yield {"target_vec": torch.from_numpy(vecs).to(device)}

    val_vecs = torch.from_numpy(np.stack(
        [val_ds[j][1] for j in range(min(len(val_ds), 512))])).to(device)
    best = float("inf")
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = [step(state, b, step_generator(args.seed, epoch, i))[1]["loss"]
                  for i, b in enumerate(batches(epoch))]
        net.eval()
        with torch.inference_mode():
            recon = net(None, None, val_vecs[:, :d.n_pre_poses], val_vecs,
                        input_mode="pose")[-1]
        val = float(torch.mean(torch.abs(recon - val_vecs)))
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        print(f"epoch {epoch + 1}: train loss {train_loss:.4f} "
              f"val recon L1 {val:.4f} ({time.time() - t0:.1f}s)")
        if val < best:
            best = val
            ckpt.save(epoch, state.state_dict(), metadata={"loss": val, "epoch": epoch})
            print(f"  saved (best val recon {best:.4f})")
    print(f"done; export with: python -m hop_tpu_torch.eval.export_eval_net "
          f"--checkpoint-dir {args.checkpoint_dir} --out evalnet.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
