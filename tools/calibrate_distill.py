#!/usr/bin/env python3
"""Readings for the limits of a distill cell's ``correct``, for any distill
kind of mix (``distill``, ``distill_remat``).

    python3 tools/calibrate_distill.py --workload <cell> --seeds 1,2,3 [--kinds control,half]

``benchmark/calibrate.py`` takes every mix whose kind is not "distill" for
a serving mix; this script runs its distill readings through the cell's
own driver: the driver's reference (``Driver.reference``) in float32 from
the seed's weights and batches, then each kind put in the program's place
and held against it with ``benchmark.drivers.distill.compare``.  Kinds:
``control`` the reference in float8 (e4m3 operands, e5m2 gradients),
``half`` the reference's step on half of each batch, ``unchanged`` no
update.  Prints one JSON line per seed and kind with the numbers the cell
compares.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="control,half")
    args = ap.parse_args()

    import torch

    from benchmark import run
    from benchmark.drivers.distill import compare
    from benchmark.reference import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == args.workload)
    bench = REPO / "benchmark"
    limits = json.loads((bench / "workloads" / f"{args.workload}.json").read_text())["limits"]
    config = json.loads((bench / "configs" / f"{entry['config']}.json").read_text())
    mix = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        driver = run.driver_class(REPO, mix["kind"])(config, mix, run.seeds(seed),
                                                     torch.device("cuda"))
        driver.make_feed()
        ref = driver.reference()
        for kind in args.kinds.split(","):
            got = driver.reference(M.FP8) if kind == "control" else driver.reference(fault=kind)
            found = compare(got, ref)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              **{k: found[k] for k in limits}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
