"""The port's parallel CLI on the CPU: ``cli.distill`` under ``python -m
torch.distributed.run`` (gloo, 2 and 4 processes) with ``--num_data_shards``,
``--tensor_parallel`` and ``--fsdp``, ``--fsdp`` on one process, the errors
of a layout the run cannot hold, and a SIGTERM to one rank (tiny model, the
synthetic corpus of ``tests/test_torch_pipeline.py``).  Every process has
its own time limit."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dphubert_torch.interop.torch_ckpt import load_checkpoint, model_from_checkpoint
from dphubert_torch.parallel import dryrun

from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    _common_flags,
    corpus,
    one_torch_thread,
    teacher_ckpt,
)
from tests.torch_parallel_worker import ENTRY

REPO = pathlib.Path(__file__).resolve().parents[1]


def _stage1_argv(tsv, teacher, exp, *extra):
    return _common_flags(tsv, teacher) + [
        "--student_ckpt", str(teacher), "--exp_dir", str(exp), "--max_updates", "2",
        "--sparsity_warmup_updates", "1", "--target_sparsity", "0.3", "--num_workers", "0",
        "--pruning_units", "head,interm", *extra]


def _torchrun(n, argv, timeout=240):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), "-m", "dphubert_torch.cli.distill", *argv]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)))


def test_torchrun_four_processes_two_by_two_exits_0_and_exports_one_card(
        corpus, teacher_ckpt, tmp_path):
    """Stage 1 on 4 processes, ``--num_data_shards 2 --tensor_parallel 2``:
    exit 0; rank 0 alone logs; the checkpoint and the exported ``.pth`` hold
    the one-card state, which loads and serves in one process."""
    _, tsv = corpus
    exp = tmp_path / "stage1"
    proc = _torchrun(4, _stage1_argv(tsv, teacher_ckpt, exp, "--num_data_shards", "2",
                                     "--tensor_parallel", "2"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    rows = [json.loads(r) for r in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and np.isfinite(rows[-1]["loss"])
    ckpt = torch.load(exp / "ckpts" / "last.pt", weights_only=True)
    assert ckpt["meta"]["layout"] == [2, 2] and ckpt["step"] == 2
    exported = load_checkpoint(exp / "ckpts" / "distilled.pth")
    model = model_from_checkpoint(exported, device="cpu")  # strict: one-card shapes
    for k, v in exported["state_dict"].items():
        assert tuple(v.shape) == tuple(ckpt["params"][f"student.{k}"].shape), k
    with torch.inference_mode():
        outs, _ = model.extract_features(torch.zeros(1, 32000))
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_torchrun_four_processes_tensor_parallel_plus_fsdp(corpus, teacher_ckpt, tmp_path):
    """``--tensor_parallel 2 --fsdp`` on 4 processes (HSDP: a (2 x 2) mesh
    whose large leaves are also split over the data ranks; the TPU CLI
    test ``test_cli_distill_tp_plus_fsdp``): exit 0, finite losses logged,
    and a one-card ``distilled.pth`` with finite weights that loads in one
    process."""
    _, tsv = corpus
    exp = tmp_path / "tp_fsdp"
    proc = _torchrun(4, _stage1_argv(tsv, teacher_ckpt, exp, "--tensor_parallel", "2",
                                     "--fsdp"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    rows = [json.loads(r) for r in (exp / "metrics.jsonl").read_text().splitlines()]
    assert rows and np.isfinite(rows[-1]["loss"])
    exported = load_checkpoint(exp / "ckpts" / "distilled.pth")
    for k, v in exported["state_dict"].items():
        assert np.isfinite(np.asarray(v)).all(), k
    model_from_checkpoint(exported, device="cpu")  # strict: one-card shapes
    assert torch.load(exp / "ckpts" / "last.pt", weights_only=True)["meta"]["layout"] == [2, 2]


def test_tensor_parallel_larger_than_the_run_fails_loudly(corpus, teacher_ckpt, tmp_path):
    _, tsv = corpus
    proc = _torchrun(2, _stage1_argv(tsv, teacher_ckpt, tmp_path / "x",
                                     "--tensor_parallel", "3"))
    assert proc.returncode != 0
    assert "--tensor_parallel 3 needs at least 3 devices" in proc.stdout + proc.stderr


@pytest.mark.parametrize("flags,message", [
    (("--tensor_parallel", "2"), "--tensor_parallel 2 needs at least 2 devices"),
    (("--num_data_shards", "2"), "--num_data_shards 2 needs 2 devices"),
])
def test_refused_flags_on_one_process(corpus, teacher_ckpt, tmp_path, flags, message):
    """A layout one process cannot hold fails before any work."""
    from dphubert_torch.cli import distill

    _, tsv = corpus
    with pytest.raises(SystemExit, match=message):
        distill.cli_main(_stage1_argv(tsv, teacher_ckpt, tmp_path / "x", *flags))


def test_fsdp_on_one_process_trains_as_without_it(corpus, teacher_ckpt, tmp_path):
    """``--fsdp`` on one process (one data rank: nothing to split, as the
    TPU CLI at n_data = 1) runs stage 1 and ends bit for bit where the run
    without it ends: the logged metrics and the exported weights."""
    from dphubert_torch.cli import distill

    _, tsv = corpus
    runs = {}
    for name, flags in (("plain", ()), ("fsdp", ("--fsdp",))):
        exp = tmp_path / name
        distill.cli_main(_stage1_argv(tsv, teacher_ckpt, exp, *flags))
        rows = [json.loads(r) for r in (exp / "metrics.jsonl").read_text().splitlines()]
        runs[name] = ([{k: v for k, v in r.items()
                        if k not in ("elapsed", "steps_per_sec", "audio_sec_per_sec")}
                       for r in rows], load_checkpoint(exp / "ckpts" / "distilled.pth"))
    (rows_p, ck_p), (rows_f, ck_f) = runs["plain"], runs["fsdp"]
    assert [r["step"] for r in rows_f] == [1, 2] and rows_f == rows_p
    for k, v in ck_p["state_dict"].items():
        assert np.array_equal(np.asarray(ck_f["state_dict"][k]), np.asarray(v)), k


def test_sigterm_to_one_rank_stops_both_with_75(corpus, teacher_ckpt, tmp_path):
    """Two ranks run stage 1 through ``cli.distill`` (data parallel); once
    training runs, rank 1 alone gets SIGTERM.  The ranks agree the stop at
    the next dispatch boundary: both exit 75 without hanging, rank 0 has
    written the checkpoint and ``exit_code``, and nothing is exported."""
    _, tsv = corpus
    exp = tmp_path / "stage1"
    marker = tmp_path / "training"
    argv = _stage1_argv(tsv, teacher_ckpt, exp)
    argv[argv.index("--max_updates") + 1] = "100000"
    torch.save({"argv": argv, "marker": str(marker)}, tmp_path / "in.pt")
    procs = dryrun.start(ENTRY, "cli_distill", 2, tmp_path, (2, 1), device="cpu", cwd=REPO)
    try:
        deadline = time.time() + 120
        while not marker.exists():
            assert time.time() < deadline, "training never started"
            assert all(p.poll() is None for p in procs), [p.communicate()[0] for p in procs]
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [75, 75], outs
    assert (exp / "exit_code").read_text().strip() == "75"
    assert torch.load(exp / "ckpts" / "last.pt", weights_only=True)["step"] >= 1
    assert not (exp / "ckpts" / "distilled.pth").exists()
