"""Smoke-load a compressed checkpoint and run it on one second of silence.

usage: python -m dphubert_torch.cli.load_dpmodel [ckpt.pth] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from ..interop.torch_ckpt import load_model


def cli_main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt", nargs="?", default="pruned_hubert_base.pth")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    model = load_model(args.ckpt, device=args.device)
    n = sum(p.numel() for p in model.parameters())
    print(f"Loaded {args.ckpt}: {n:,} parameters")
    wave = torch.zeros((1, 16000), device=model.feature_extractor.dummy_weight.device)
    with torch.inference_mode():
        outs, _ = model.extract_features(wave)
    print(f"extract_features: {len(outs)} layers, last {tuple(outs[-1].shape)}")


if __name__ == "__main__":
    cli_main()
