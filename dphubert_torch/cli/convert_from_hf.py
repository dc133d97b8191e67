"""Convert a HuggingFace checkpoint to the portable format (reference
``convert_hubert_from_hf.py`` / ``convert_wavlm_from_hf.py``; the TPU
package's ``cli/convert_from_hf.py``).

Needs ``transformers`` (imported when the CLI runs, so this module imports
without it) and a local model directory, or a hub id where the network is
reachable::

    python -m dphubert_torch.cli.convert_from_hf \\
        --model facebook/hubert-base-ls960 --type hubert \\
        --out pretrained/hubert-base-ls960.hf.pth

The conversion only renames and copies tensors, so it runs on the CPU.  The
output loads with ``dphubert_torch.interop.load_model`` and with the TPU
package's.
"""

from __future__ import annotations

import pathlib
from argparse import ArgumentParser

from ..interop.hf import import_huggingface_model
from ..interop.torch_ckpt import save_checkpoint, verify_strict


def cli_main(argv=None):
    parser = ArgumentParser(description="Convert a HuggingFace model.")
    parser.add_argument("--model", required=True,
                        help="Local path or hub id of the HF model.")
    parser.add_argument("--type", default="hubert",
                        choices=["hubert", "wav2vec2", "wavlm"])
    parser.add_argument("--out", type=pathlib.Path, required=True)
    args = parser.parse_args(argv)

    from transformers import HubertModel, Wav2Vec2Model, WavLMModel

    cls = {"hubert": HubertModel, "wav2vec2": Wav2Vec2Model, "wavlm": WavLMModel}[
        args.type
    ]
    original = cls.from_pretrained(args.model)
    model, sd = import_huggingface_model(original, device="cpu")
    verify_strict(model, sd)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(args.out, model.config, sd)
    print(f"Saved converted checkpoint to {args.out}")


if __name__ == "__main__":
    cli_main()
