#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the control and the planted
faults, each put in the program's place and held against the reference at
the cell's own size (not run by the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--kinds control,half]

Kinds: ``control`` the reference computed in float8 (e4m3 operands, e5m2
gradients) against the float32 reference, the step below the cells' bf16;
``half`` (distill cells) the reference's step on half of each batch, the
mean taken over the rest; ``altered`` (serve cells) one answer's features
shifted by a tenth of their spread where they are produced.  Prints one JSON
line per seed and kind with the numbers the cell compares.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, kinds, device="cuda", root: pathlib.Path = ROOT) -> list:
    import numpy as np
    import torch

    from benchmark import run
    from benchmark.drivers.distill import compare
    from benchmark.lib.checks import feature_gap
    from benchmark.reference import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    bench = root / "benchmark"
    spec = json.loads((bench / "workloads" / f"{cell}.json").read_text())
    config = json.loads((bench / "configs" / f"{entry['config']}.json").read_text())
    mix = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    driver = run.driver_class(root, mix["kind"])(config, mix, run.seeds(seed),
                                                 torch.device(device))
    driver.make_feed()
    ref = driver.reference()
    out = []
    for kind in kinds:
        if mix["kind"] == "distill":
            got = driver.reference(M.FP8) if kind == "control" else driver.reference(fault=kind)
            found = compare(got, ref)
        else:
            if kind == "control":
                got = driver.reference(M.FP8)
            else:  # one answer altered where it is produced
                got = {r: [f.copy() for f in feats] for r, feats in ref.items()}
                first = got[driver.feed.check[0]][0]
                first += 0.1 * first.std()
            gaps = [max(feature_gap(g, w) for g, w in zip(got[r], ref[r])) for r in ref]
            found = {"feature_gap": float(np.max(gaps))}
        row = {"workload": cell, "seed": seed, "kind": kind,
               **{k: found[k] for k in spec["limits"]}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="control")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        readings(args.workload, seed, args.kinds.split(","))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
