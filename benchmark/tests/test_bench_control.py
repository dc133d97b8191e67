"""The control of every cell's comparison: the reference computed one
precision below the configuration's bf16 (float8), put in the program's
place, must come out not correct, on three seeds; on the card at the cells'
own sizes (marked ``gpu``), on the CPU at the tiny cells' sizes under the
real cells' limits."""

import json
import pathlib

import pytest

from benchmark import calibrate
from benchmark.tests import tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]
CELLS = ("hubert_base.distill", "hubert_base.serve", "wavlm_base.distill",
         "wavlm_base.serve_long")
SEEDS = (2_147_490_001, 2_147_490_002, 2_147_490_003)


def limits(cell):
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["limits"]


def fails(row, lim):
    return any(row[k] > v for k, v in lim.items())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    for seed in SEEDS:
        (row,) = calibrate.readings(cell, seed, ["control"])
        assert fails(row, limits(cell)), row


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails_at_a_tiny_size(tmp_path, cell):
    root = tiny.write_tree(tmp_path)
    real = limits("hubert_base.distill" if cell.endswith("distill") else "hubert_base.serve")
    for seed in SEEDS:
        (row,) = calibrate.readings(cell, seed, ["control"], device="cpu", root=root)
        assert fails(row, real), row
