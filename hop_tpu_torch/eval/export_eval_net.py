"""Export a trained feature-net checkpoint as an `--eval-net` (port of
hop_tpu/eval/export_eval_net.py).

The reference evaluates FGD with a frozen, pretrained feature net
(`gesture_autoencoder_checkpoint_best.bin` for TED, a MotionAE checkpoint
for TED Expressive; EmbeddingSpaceEvaluator.py:393-414). In the port that
net is trained with `--model gesture_autoencoder` (EmbeddingNet in pose
mode on TED, the MotionAE on TED Expressive) or by `cli.train_h36m_ae`;
this tool turns its checkpoint into the flat .npz of flax variables that
hop_tpu's `save_arrays` writes (`convert.embedding_net_to_jax` /
`motion_ae_to_jax`, `convert.save_npz_variables`), which both packages'
`--eval-net` read:

  python -m hop_tpu_torch.cli.run_ted --model gesture_autoencoder ... \
      --checkpoint-dir /ck/ae
  python -m hop_tpu_torch.eval.export_eval_net --checkpoint-dir /ck/ae \
      --out evalnet.npz
  python -m hop_tpu_torch.cli.run_ted --model AD_LLM ... --eval-net evalnet.npz

A joint_embedding checkpoint decodes with a GRU, not the pose-mode
feature net's convolutions, and is refused by name.
"""

from __future__ import annotations

import argparse
from typing import Optional

from hop_tpu_torch import convert
from hop_tpu_torch.utils.checkpoint import CheckpointManager


def export(checkpoint_dir: str, out: str, step: Optional[int] = None) -> dict:
    """The checkpoint's feature net -> `out` (.npz); returns the variables."""
    ckpt = CheckpointManager(checkpoint_dir)
    if ckpt.latest_step() is None:
        raise SystemExit(f"no checkpoint found in {checkpoint_dir}")
    model = ckpt.run_metadata().get("model", "?")
    if model != "gesture_autoencoder":
        raise SystemExit(
            f"checkpoint is a {model!r} run: the FGD feature net comes from "
            "--model gesture_autoencoder or train_h36m_ae (the reference trains it "
            "with train_eval/train_joint_embed.py)")
    saved = ckpt.restore(step)
    if "net" not in saved:
        raise SystemExit(f"unexpected state keys {sorted(saved)}")
    sd = saved["net"]
    to_jax = (convert.motion_ae_to_jax if "encoder.net.3.weight" in sd
              else convert.embedding_net_to_jax)
    variables = to_jax(sd)
    convert.save_npz_variables(out, variables)
    return variables


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    args = p.parse_args(argv)
    export(args.checkpoint_dir, args.out, args.step)
    print(f"exported eval net -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
