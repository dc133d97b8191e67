"""Manifest creation (reference ``prepare_data.py``)."""

from __future__ import annotations

import pathlib
from argparse import ArgumentParser

from ..data.manifest import create_tsv


def cli_main(argv=None):
    parser = ArgumentParser(description="Prepare audio data.")
    parser.add_argument("--data", type=pathlib.Path, required=True)
    parser.add_argument("--out", type=pathlib.Path,
                        default=pathlib.Path("data/librispeech"))
    parser.add_argument("--extension", type=str, default="flac")
    args = parser.parse_args(argv)
    if not args.data.is_dir():
        raise SystemExit(f"not a directory: {args.data}")
    args.out.mkdir(parents=True, exist_ok=True)
    create_tsv(root_dir=args.data, out_dir=args.out, extension=args.extension)
    print("Finished creating the file lists successfully")


if __name__ == "__main__":
    cli_main()
