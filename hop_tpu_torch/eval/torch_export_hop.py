"""A trained HOP generator of the port in the reference's checkpoint format
(port of hop_tpu/eval/torch_export_hop.py).

The port's HOPModel carries the reference's state_dict names, so the
payload `{'generator': state_dict}` that the reference saves
(run_ted.py:457-460) and its test_checkpoint.py:312-315 reads is the
model's state_dict less what hop_tpu's export leaves out: the frozen
backbone (`llm_model.*`: the reference builds it with from_pretrained
before load_state_dict) and the reference's dead blocks (the WavEncoder it
never calls under use_gwnet, gwnet.residual_convs under gcn_bool), which
the port does not build. Load it with strict=False.

  python -m hop_tpu_torch.eval.torch_export_hop --checkpoint-dir ./checkpoints \
      --out hop_generator.bin [--expressive] [--device cuda]
"""

from __future__ import annotations

import argparse
from collections import OrderedDict

import torch

from hop_tpu_torch.config import Config


def export_hop_state_dict(model, cfg: Config) -> "OrderedDict[str, torch.Tensor]":
    """The trained part of a HOPModel's state_dict, on the CPU, under the
    reference's names: everything but `llm_model.*`."""
    return OrderedDict((k, v.detach().cpu().clone()) for k, v in model.state_dict().items()
                       if not k.startswith("llm_model."))


def main(argv=None):
    from hop_tpu_torch.cli.common import restore_hop_model
    from hop_tpu_torch.config import expressive_config, ted_config, tiny_test_config

    p = argparse.ArgumentParser("export a HOP checkpoint to the reference's torch format")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True,
                   help="output .bin (torch.save({'generator': ...}))")
    p.add_argument("--expressive", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="thin layers (tiny_test_config), as the run was trained")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dataset = "TED_expressive" if args.expressive else "TED"
    cfg = (tiny_test_config(dataset) if args.tiny else
           expressive_config() if args.expressive else ted_config())
    cfg, model, _ = restore_hop_model(cfg, args.checkpoint_dir, device=args.device)
    sd = export_hop_state_dict(model, cfg)
    torch.save({"generator": sd}, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors; frozen llm_model.* and the "
          "reference's dead blocks omitted — load_state_dict(strict=False))")


if __name__ == "__main__":
    main()
