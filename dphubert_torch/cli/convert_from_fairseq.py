"""Convert a fairseq wav2vec 2.0 / HuBERT checkpoint to the portable format
(reference ``convert_*_from_fairseq.py``, six scripts in one CLI; the TPU
package's ``cli/convert_from_fairseq.py``).

Works on the state dict (fairseq itself is not needed when the
checkpoint's ``model`` entry holds plain tensors)::

    python -m dphubert_torch.cli.convert_from_fairseq \\
        --ckpt hubert_base_ls960.pt --arch hubert_base \\
        --out pretrained/hubert-base-ls960.fairseq.pth

Keys the checkpoint lacks (``dummy_weight``) come from a fresh init of the
architecture drawn from a CPU generator seeded with 0; the conversion runs
on the CPU.
"""

from __future__ import annotations

import pathlib
from argparse import ArgumentParser

import numpy as np
import torch

from ..interop.hf import fill_from_init, rename_fairseq_state_dict
from ..interop.torch_ckpt import save_checkpoint
from ..models import model as model_factories

# the architectures of the reference's converters -> the factory's name
# (the Large family: layer-norm extractor and per-utterance waveform
# normalisation, convert_hubert_large_from_fairseq.py:40)
ARCHES = {
    "wav2vec2_base": "wav2vec2_base",
    "wav2vec2_large": "wav2vec2_large",
    "wav2vec2_large_lv60k": "wav2vec2_large_lv60k",
    "hubert_base": "hubert_base",
    "hubert_large": "hubert_large",
    "hubert_xlarge": "hubert_xlarge",
}


def convert(ckpt_path, arch: str):
    """A fairseq checkpoint file -> (model on the CPU, flat numpy state
    dict in our names, complete for ``arch``)."""
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("model", raw.get("state_dict", raw))
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}
    sd = rename_fairseq_state_dict(sd)

    model = getattr(model_factories, ARCHES[arch])(
        device="cpu", generator=torch.Generator().manual_seed(0))
    sd, missing, unexpected = fill_from_init(model.state_dict(), sd)
    print(f"Missing (fresh init): {missing}\nUnexpected (dropped): {unexpected}")
    return model, sd


def cli_main(argv=None):
    parser = ArgumentParser(description="Convert a fairseq checkpoint.")
    parser.add_argument("--ckpt", type=pathlib.Path, required=True)
    parser.add_argument("--arch", choices=sorted(ARCHES), required=True)
    parser.add_argument("--out", type=pathlib.Path, required=True)
    args = parser.parse_args(argv)
    model, sd = convert(args.ckpt, args.arch)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(args.out, model.config, sd)
    print(f"Saved converted checkpoint to {args.out}")


if __name__ == "__main__":
    cli_main()
