"""TED Gesture training entry point (port of hop_tpu/cli/run_ted.py,
reference run_ted.py).

  python -m hop_tpu_torch.cli.run_ted --data synthetic --synthetic-videos 20 \
      --epochs 4 --warmup-epochs 0
  python -m hop_tpu_torch.cli.run_ted --device cpu --tiny --synthetic-videos 1 \
      --batch-size 8 --epochs 2 --warmup-epochs 0 --checkpoint-dir /tmp/ck
  python -m hop_tpu_torch.cli.run_ted ... --epochs 4 --resume
"""

from __future__ import annotations

from hop_tpu_torch.cli.common import base_parser
from hop_tpu_torch.cli.train_main import train_main
from hop_tpu_torch.config import ted_config, tiny_test_config


def main(argv=None):
    """Returns (state, best_fgd)."""
    args = base_parser("HOP (PyTorch) TED Gesture training").parse_args(argv)
    cfg = tiny_test_config("TED") if args.tiny else ted_config()
    state, best = train_main(cfg, args)
    print(f"done; best FGD {best:.4f}")
    return state, best


if __name__ == "__main__":
    main()
