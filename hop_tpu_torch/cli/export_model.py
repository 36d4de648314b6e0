"""Export a trained HOP generator for serving (port of
hop_tpu/cli/export_model.py).

Writes the fixed-shape generation forward of the latest checkpoint in
--checkpoint-dir (`cli.common.restore_hop_model`) as a `torch.export`
program (`infer.export_forward`): a serving process loads it with
`hop_tpu_torch.infer.load_exported` and runs it with no model code, the
kernels' forwards reached as `torch.ops.hop_tpu_torch.*`. The program
carries its weights and runs on the one device it was exported on
(--device, or the one platform of --platforms). --params-out also writes
the generator's state_dict as a flat .npz under the reference's names
(hop_tpu writes flax variable paths there).

  python -m hop_tpu_torch.cli.export_model --checkpoint-dir ./checkpoints \
      --out hop_serving.pt2 [--params-out hop_params.npz] [--batch-size 1] \
      [--device cuda] [--gru-kernel fused|stack] [--bert-attention plain|fused|block]

Round trip: `hop_tpu_torch.infer.load_exported(blob)(in_audio, log_mel,
text, pre_seq, vid, eps)`.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from hop_tpu_torch.cli.common import restore_hop_model
from hop_tpu_torch.config import expressive_config, ted_config, tiny_test_config
from hop_tpu_torch.infer import export_forward

def device_of(args) -> str:
    """--device, or the one platform --platforms names (a torch artifact is
    bound to one device: two are refused)."""
    if not args.platforms:
        return args.device
    names = [s.strip().lower() for s in args.platforms.split(",") if s.strip()]
    if len(names) != 1:
        raise SystemExit(f"--platforms {args.platforms}: a torch.export artifact runs "
                         "on the one device it was exported on; export once per platform")
    if names[0] not in ("cuda", "cpu"):
        raise SystemExit(f"--platforms {names[0]}: the port exports for cuda or cpu")
    return names[0]


def main(argv=None):
    p = argparse.ArgumentParser("export a HOP generator for serving")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True,
                   help="output path for the torch.export program")
    p.add_argument("--params-out", default=None,
                   help="also write the weights as a flat .npz (keys are the "
                        "state_dict's names, the reference's)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--platforms", default=None,
                   help="the one device to export for (cuda or cpu); in place "
                        "of --device")
    p.add_argument("--device", default="cuda")
    p.add_argument("--expressive", action="store_true",
                   help="TED-Expressive config (pose_dim 126)")
    p.add_argument("--tiny", action="store_true",
                   help="thin layers (tiny_test_config), as the run was trained")
    p.add_argument("--gru-kernel", default="fused", choices=("fused", "stack"))
    p.add_argument("--bert-attention", default="plain",
                   choices=("plain", "fused", "block"))
    args = p.parse_args(argv)

    device = device_of(args)
    dataset = "TED_expressive" if args.expressive else "TED"
    if args.tiny:
        cfg = tiny_test_config(dataset)
    else:
        cfg = expressive_config() if args.expressive else ted_config()
    cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, gru_kernel=args.gru_kernel),
                      llm=dataclasses.replace(cfg.llm, attention=args.bert_attention))
    cfg, model, n_speakers = restore_hop_model(cfg, args.checkpoint_dir, device=device)

    blob = export_forward(model, cfg, batch_size=args.batch_size, device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob) / 1e6:.2f} MB, batch={args.batch_size}, "
          f"n_speakers={n_speakers}, device={device})")

    if args.params_out:
        flat = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        np.savez(args.params_out, **flat)
        print(f"wrote {args.params_out} ({len(flat)} arrays)")


if __name__ == "__main__":
    main()
