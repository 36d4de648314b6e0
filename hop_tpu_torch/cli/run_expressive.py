"""TED Expressive training entry point (port of hop_tpu/cli/run_expressive.py,
reference run_expressive.py): pose_dim 126, lr 0.005, loss weights
2100/5/0.8/0.5."""

from __future__ import annotations

from hop_tpu_torch.cli.common import base_parser
from hop_tpu_torch.cli.train_main import train_main
from hop_tpu_torch.config import expressive_config, tiny_test_config


def main(argv=None):
    """Returns (state, best_fgd)."""
    args = base_parser("HOP (PyTorch) TED Expressive training").parse_args(argv)
    cfg = tiny_test_config("TED_expressive") if args.tiny else expressive_config()
    state, best = train_main(cfg, args)
    print(f"done; best FGD {best:.4f}")
    return state, best


if __name__ == "__main__":
    main()
