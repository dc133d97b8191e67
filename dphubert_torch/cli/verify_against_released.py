"""Parity check against a released DPHuBERT/DPWavLM checkpoint (the TPU
package's ``cli/verify_against_released.py``).

Loads a released compressed checkpoint (e.g. ``DPHuBERT-sp0.75.pth`` from
https://huggingface.co/pyf98/DPHuBERT, reference ``README.md:92-112``) into
BOTH this package and the reference's torch implementation, runs both on
the same audio, and checks the hidden states layer by layer.

Usage::

    python -m dphubert_torch.cli.verify_against_released \\
        --ckpt /path/to/DPHuBERT-sp0.75.pth \\
        [--audio /path/to/clip.wav] [--reference_dir /path/to/reference] \\
        [--atol 1e-4] [--expect_params 23585946] [--device cuda]

Without ``--audio`` a deterministic synthetic clip is used.  This package's
side runs on ``--device`` (the card by default; ``cpu`` on a host without
one) in fp32 with TF32 off; the reference runs on the CPU.

Exit code 0 = all layers within tolerance; 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def cli_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Verify a released compressed checkpoint against the "
        "torch reference implementation layer by layer."
    )
    parser.add_argument("--ckpt", required=True, help="released .pth checkpoint")
    parser.add_argument("--audio", default=None, help="wav/flac clip (synthetic if omitted)")
    parser.add_argument("--reference_dir", default="reference",
                        help="checkout of the reference's code (holds wav2vec2/model.py)")
    parser.add_argument("--atol", type=float, default=1e-4)
    parser.add_argument("--rtol", type=float, default=1e-4)
    parser.add_argument(
        "--expect_params", type=int, default=None,
        help="assert total parameter count (README: DPHuBERT-sp0.75 = "
        "23585946, DPWavLM-sp0.75 = 23586325)",
    )
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda",
                        help="where this package's model runs: cuda (the card) or cpu")
    args = parser.parse_args(argv)

    from ..interop.torch_ckpt import load_checkpoint, model_from_checkpoint

    # parity needs true fp32 products and convolutions on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ckpt = load_checkpoint(args.ckpt)
    model = model_from_checkpoint(ckpt, args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"native load: {n_params:,} parameters")
    if args.expect_params is not None and n_params != args.expect_params:
        print(f"FAIL: expected {args.expect_params:,} parameters")
        return 1

    if args.audio is not None:
        from ..data.audio import load_audio

        wave, sr = load_audio(args.audio)
        wave = np.asarray(wave, np.float32).reshape(1, -1)
        print(f"audio: {args.audio} ({wave.shape[1]} samples @ {sr} Hz)")
    else:
        n = int(args.seconds * 16000)
        wave = (
            np.random.default_rng(0).standard_normal((1, n)).astype(np.float32)
            * 0.1
        )
        print(f"audio: synthetic {n} samples")

    device = model.feature_extractor.dummy_weight.device
    with torch.inference_mode():
        outs, _ = model.extract_features(torch.from_numpy(wave).to(device))
    outs = [o.float().cpu().numpy() for o in outs]

    # the reference side
    sys.path.insert(0, args.reference_dir)
    try:
        from wav2vec2.model import wav2vec2_model as torch_wav2vec2_model

        tmodel = torch_wav2vec2_model(**ckpt["config"])
        result = tmodel.load_state_dict(
            {k: torch.tensor(v) for k, v in ckpt["state_dict"].items()},
            strict=False,
        )
        if result.unexpected_keys:
            print(f"FAIL: unexpected keys in reference load: {result.unexpected_keys}")
            return 1
        tmodel.eval()
        with torch.no_grad():
            touts, _ = tmodel.extract_features(torch.tensor(wave))
        touts = [t.numpy() for t in touts]
    finally:
        sys.path.remove(args.reference_dir)

    if len(outs) != len(touts):
        print(f"FAIL: layer count {len(outs)} != reference {len(touts)}")
        return 1

    status = 0
    for i, (a, b) in enumerate(zip(outs, touts)):
        err = np.abs(a - b).max()
        ok = np.allclose(a, b, atol=args.atol, rtol=args.rtol)
        print(f"layer {i:2d}: max|diff| = {err:.3e}  {'ok' if ok else 'FAIL'}")
        status |= 0 if ok else 1
    print("PASS" if status == 0 else "FAIL")
    return status


if __name__ == "__main__":
    raise SystemExit(cli_main())
