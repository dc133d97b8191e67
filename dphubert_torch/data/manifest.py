"""tsv manifests (a copy of the TPU package's ``data/manifest.py``), the
same on-disk format as the reference (``prepare_data.py``,
``audio_dataset.py:238-262``): first line is the root directory, then
``relpath\\tnum_samples`` rows."""

from __future__ import annotations

import pathlib
from typing import List, Tuple, Union

import numpy as np

from .audio import audio_info


def read_manifest(tsv_dir, subset: str):
    """Returns (paths: np.ndarray[str], indices, lengths) like the reference
    ``AudioDataset._get_lists``."""
    tsv_dir = pathlib.Path(tsv_dir)
    rows: List[Tuple[str, int, int]] = []
    with open(tsv_dir / f"{subset}.tsv") as f:
        root = f.readline().rstrip()
        for index, line in enumerate(f):
            path, nsample = line.split("\t")
            rows.append((f"{root}/{path}", index, int(nsample)))
    if not rows:
        raise ValueError(f"empty manifest {tsv_dir}/{subset}.tsv")
    paths, indices, lengths = zip(*rows)
    return np.asarray(paths), np.asarray(indices), np.asarray(lengths)


def create_tsv(
    root_dir: Union[str, pathlib.Path],
    out_dir: Union[str, pathlib.Path],
    extension: str = "flac",
) -> None:
    """Walk a LibriSpeech-style tree and write train100/train960/valid tsvs
    (dev* -> valid), mirroring the reference ``create_tsv``."""
    root_dir = pathlib.Path(root_dir)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    with open(out_dir / "train100.tsv", "w") as t100, open(
        out_dir / "train960.tsv", "w"
    ) as t960, open(out_dir / "valid.tsv", "w") as valid:
        print(root_dir, file=t100)
        print(root_dir, file=t960)
        print(root_dir, file=valid)
        for fname in sorted(root_dir.glob(f"**/*.{extension}")):
            num_frames, _, _ = audio_info(fname)
            line = f"{fname.relative_to(root_dir)}\t{num_frames}"
            s = str(fname)
            if "train-clean-100" in s:
                print(line, file=t100)
            if "train" in s:
                print(line, file=t960)
            if "dev" in s:
                print(line, file=valid)
