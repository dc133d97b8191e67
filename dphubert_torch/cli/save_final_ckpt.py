"""Merge the final-distill weights with the pruned config
(reference ``save_final_ckpt.py``).  Host-side: it takes no device."""

from __future__ import annotations

import json
import pathlib
from argparse import ArgumentParser

from ..interop.torch_ckpt import load_checkpoint, save_checkpoint
from .prune import _student_state_dict, load_pruned_model


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Merge final-distill weights with the pruned config "
        "into a portable checkpoint."
    )
    parser.add_argument("--config_path", type=pathlib.Path, required=True,
                        help="Checkpoint containing the pruned config.")
    parser.add_argument("--ckpt_after_final_distill", type=pathlib.Path,
                        required=True)
    parser.add_argument("--out", type=pathlib.Path, default=None)
    return parser.parse_args(argv)


def cli_main(argv=None):
    args = parse_args(argv)
    config = load_checkpoint(args.config_path)["config"]
    print(json.dumps(config, indent=4))

    ckpt = load_checkpoint(args.ckpt_after_final_distill)
    state_dict = _student_state_dict(ckpt["state_dict"])
    out_path = args.out or (
        args.ckpt_after_final_distill.parent / "pruned_hubert_base.pth"
    )
    save_checkpoint(out_path, config, state_dict, ckpt.get("distill_linear_projs", {}))
    load_pruned_model(out_path)  # strict reload check
    print(f"Wrote pruned model checkpoint (weights + config): {out_path}")


if __name__ == "__main__":
    cli_main()
