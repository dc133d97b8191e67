"""The recipe driver ``run_torch.sh`` and the trainer's RSS watchdog, on the
CPU with the tiny configs and the synthetic corpus of
``tests/test_torch_pipeline.py``.

* ``run_torch.sh`` with ``DEVICE=cpu`` runs the four stages through the
  port's CLIs (each a process of its own) and ends in a ``dphubert.pth``
  that serves;
* a tiny ``DPHUBERT_MAX_RSS_GB`` stops stage 1 at its first reading of the
  resident memory with a checkpoint and exit code 75; resumed with the
  limit lifted (the watchdog reads again at the first step after a resume,
  so under the same limit it would stop again), the stage equals the
  uninterrupted run bit for bit.
"""

import os
import pathlib
import subprocess

import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.interop.torch_ckpt import load_checkpoint, model_from_checkpoint
from dphubert_torch.train import trainer

from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    _common_flags,
    corpus,
    one_torch_thread,
    teacher_ckpt,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run_torch_sh(tsv, teacher_ckpt, exp, cwd, **env_over):
    env = dict(os.environ, TSV_DIR=str(tsv), TRAIN_SUBSET="train100",
               TEACHER_CKPT=str(teacher_ckpt), DISTILL_LAYERS="0.1,3",
               MAX_UPDATES="3", WARMUP_UPDATES="2", SPARSITY_WARMUP_UPDATES="2",
               FINAL_MAX_UPDATES="2", FINAL_WARMUP_UPDATES="1", SECONDS_PER_BATCH="16",
               NUM_SHAPES="2", LOG_INTERVAL="1", DEVICE="cpu", EXP_DIR=str(exp),
               OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), **env_over)
    proc = subprocess.run(["bash", str(REPO / "run_torch.sh")], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_run_torch_sh_reaches_a_served_checkpoint(corpus, teacher_ckpt, tmp_path):
    """The whole recipe script at a tiny size, with its defaults
    (``--steps_per_dispatch 4 --ckpt_backend rotated``): stage 1 (3
    updates), prune, final distill (2 updates), save_final_ckpt and
    load_dpmodel, exit 0; the exported checkpoint serves finite features and
    is smaller than the teacher; each stage's checkpoints are rotated step
    files recording K = 4."""
    _, tsv = corpus
    exp = tmp_path / "exp"
    proc = _run_torch_sh(tsv, teacher_ckpt, exp, tmp_path)
    assert f"Done: {exp}/dphubert.pth" in proc.stdout
    assert "extract_features: 4 layers" in proc.stdout  # load_dpmodel
    final = load_checkpoint(exp / "dphubert.pth")
    model = model_from_checkpoint(final, device="cpu")
    with torch.inference_mode():
        outs, _ = model.extract_features(torch.zeros(1, 32000))
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    n_teacher = sum(v.size for v in load_checkpoint(teacher_ckpt)["state_dict"].values())
    assert sum(v.size for v in final["state_dict"].values()) < n_teacher
    for stage, steps in (("stage1", 3), ("stage2", 2)):
        rotated = sorted(p.name for p in (exp / stage / "ckpts" / "rotated").glob("step_*.pt"))
        assert rotated == [f"step_{steps}.pt"], (stage, rotated)
        meta = torch.load(exp / stage / "ckpts" / "rotated" / rotated[0],
                          weights_only=True)["meta"]
        assert meta["steps_per_dispatch"] == 4
        assert not (exp / stage / "ckpts" / "last.pt").exists()


def test_run_torch_sh_with_the_last_backend(corpus, teacher_ckpt, tmp_path):
    """``CKPT_BACKEND=last STEPS_PER_DISPATCH=1``: the script passes both,
    every stage writes ``ckpts/last.pt`` (K = 1 recorded) and no rotated
    directory, and the recipe ends in a checkpoint that serves."""
    _, tsv = corpus
    exp = tmp_path / "exp"
    proc = _run_torch_sh(tsv, teacher_ckpt, exp, tmp_path, CKPT_BACKEND="last",
                         STEPS_PER_DISPATCH="1")
    assert f"Done: {exp}/dphubert.pth" in proc.stdout
    for stage, steps in (("stage1", 3), ("stage2", 2)):
        ckpt = torch.load(exp / stage / "ckpts" / "last.pt", weights_only=True)
        assert ckpt["step"] == steps and ckpt["meta"]["steps_per_dispatch"] == 1
        assert not (exp / stage / "ckpts" / "rotated").exists()


def test_run_torch_sh_with_remat_runs_four_steps_a_dispatch(corpus, teacher_ckpt, tmp_path):
    """``REMAT=1`` keeps the default of 4 steps a dispatch (a captured
    graph replays the checkpointed layers' dropout too): the two training
    stages get ``--remat --steps_per_dispatch 4`` (read by a ``python`` on
    the PATH that logs its arguments) and record K = 4."""
    import sys

    _, tsv = corpus
    bin_dir, log = tmp_path / "bin", tmp_path / "argv.log"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(
        f'#!/bin/sh\necho "$*" >> "{log}"\nexec "{sys.executable}" "$@"\n')
    (bin_dir / "python").chmod(0o755)
    exp = tmp_path / "exp"
    proc = _run_torch_sh(tsv, teacher_ckpt, exp, tmp_path, REMAT="1",
                         PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    assert f"Done: {exp}/dphubert.pth" in proc.stdout
    stages = [line for line in log.read_text().splitlines()
              if "cli.distill" in line or "cli.final_distill" in line]
    assert len(stages) == 2
    for line in stages:
        assert "--remat" in line.split() and "--steps_per_dispatch 4" in line, line
    for stage, steps in (("stage1", 3), ("stage2", 2)):
        meta = torch.load(exp / stage / "ckpts" / "rotated" / f"step_{steps}.pt",
                          weights_only=True)["meta"]
        assert meta["steps_per_dispatch"] == 4


def _stage1(corpus_tsv, teacher, exp_dir, extra=()):
    from dphubert_torch.cli import distill

    argv = _common_flags(corpus_tsv, teacher) + [
        "--student_ckpt", str(teacher), "--exp_dir", str(exp_dir), "--max_updates", "3",
        "--sparsity_warmup_updates", "2", "--target_sparsity", "0.5",
        "--pruning_units", "conv,head,interm,attlayer,ffnlayer", *extra]
    return distill.cli_main(argv)


def test_rss_watchdog_exits_75_and_the_resume_is_bit_exact(corpus, teacher_ckpt, tmp_path,
                                                          monkeypatch):
    """Through the stage-1 CLI, the watchdog reading every 2 steps instead
    of 100 (``test_rss_watchdog_reads_every_100_steps`` holds the
    interval): a 1 MB limit stops the run at step 2 with a checkpoint and
    exit 75, nothing exported; the resume, the limit lifted, equals the
    uninterrupted run bit for bit (parameters, moments, generator, the
    exported checkpoint)."""
    _, tsv = corpus
    monkeypatch.setattr(trainer, "RSS_CHECK_INTERVAL", 2)
    monkeypatch.delenv("DPHUBERT_MAX_RSS_GB", raising=False)
    full = _stage1(tsv, teacher_ckpt, tmp_path / "full")
    assert full.step == 3

    monkeypatch.setenv("DPHUBERT_MAX_RSS_GB", "0.001")  # 1 MB: exceeded at the first reading
    assert trainer.rss_limit_bytes() == 1_000_000
    exp = tmp_path / "part"
    with pytest.raises(SystemExit) as stop:
        _stage1(tsv, teacher_ckpt, exp)
    assert stop.value.code == 75
    last = exp / "ckpts" / "last.pt"
    assert torch.load(last, weights_only=True)["step"] == 2
    assert not (exp / "ckpts" / "distilled.pth").exists()

    monkeypatch.setenv("DPHUBERT_MAX_RSS_GB", "0")  # lifted: 0 disables the watchdog
    assert trainer.rss_limit_bytes() == 0
    resumed = _stage1(tsv, teacher_ckpt, exp, ["--resume_checkpoint", str(last)])
    assert resumed.step == 3
    for (k, a), (_, b) in zip(full.named_params().items(), resumed.named_params().items()):
        assert torch.equal(a, b), k
    for k in full.opt_state.mu:
        assert torch.equal(full.opt_state.mu[k], resumed.opt_state.mu[k]), k
        assert torch.equal(full.opt_state.nu[k], resumed.opt_state.nu[k]), k
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())
    a = load_checkpoint(tmp_path / "full" / "ckpts" / "distilled.pth")
    b = load_checkpoint(exp / "ckpts" / "distilled.pth")
    assert a["config"] == b["config"]
    for k, v in a["state_dict"].items():
        np.testing.assert_array_equal(b["state_dict"][k], v, err_msg=k)


class _ShortBatches:
    """A loader of 7 batches an epoch of 2 x 3,200 samples (10 frames),
    the same every epoch: steps cheap enough to reach step 200."""

    def epoch(self, e, skip=0):
        rng = np.random.default_rng(0)
        batches = [(0.1 * rng.standard_normal((2, 3200))).astype(np.float32) for _ in range(7)]
        for wave in batches[skip:]:
            yield wave, None


def test_rss_watchdog_reads_every_100_steps(tmp_path, monkeypatch):
    """The trainer reads its resident memory at steps 100 and 200 of a run,
    counting from 0 in each process: a run stopped at step 150 and resumed
    reads at step 151, its first."""
    from dphubert_torch.train import DistillConfig, train

    from tests.test_torch_pipeline import tiny_config

    reads = []
    monkeypatch.setattr(trainer, "_rss_bytes", lambda: reads.append(step_of[0]) or 0)
    monkeypatch.setenv("DPHUBERT_MAX_RSS_GB", "1")
    step_of = [0]
    real_step = trainer.make_train_step

    def counting_step(*a, **kw):
        inner = real_step(*a, **kw)

        def step(state, batch):
            out = inner(state, batch)
            step_of[0] = state.step
            return out
        return step

    monkeypatch.setattr(trainer, "make_train_step", counting_step)
    cfg = DistillConfig(distill_layer_groups=((0,), (1, 3)), use_reg=False, max_updates=201)

    def run(exp, **kw):
        teacher = pt.wav2vec2_model(device="cpu", **tiny_config())
        student = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(1),
                                    **tiny_config())
        return train(teacher=teacher, student=student, cfg=cfg, loader=_ShortBatches(),
                     exp_dir=exp, log_interval=1000, device="cpu", **kw)

    run(tmp_path / "full")
    assert reads == [100, 200]
    reads.clear()
    run(tmp_path / "part", stop_at_step=150)
    assert reads == [100]
    reads.clear()
    state = run(tmp_path / "part", resume=tmp_path / "part" / "ckpts" / "last.pt")
    assert state.step == 201 and reads == [151]


def test_rss_limit_defaults_to_085_of_the_memory_budget(monkeypatch):
    monkeypatch.delenv("DPHUBERT_MAX_RSS_GB", raising=False)
    budget = trainer._memory_budget_bytes()
    assert budget > 0
    assert trainer.rss_limit_bytes() == int(budget * 0.85)
    assert 0 < trainer._rss_bytes() < budget


def test_run_torch_sh_on_two_processes(corpus, teacher_ckpt, tmp_path):
    """``NPROC=2 DEVICE=cpu``: both training stages under torchrun on two
    gloo processes (data parallel, ``SECONDS_PER_BATCH`` each rank's
    share); the recipe ends in a checkpoint that serves, rank 0 alone logs
    (one metrics row a step), and the stages' checkpoints hold the
    one-card state with the (2, 1) layout recorded."""
    _, tsv = corpus
    exp = tmp_path / "exp"
    proc = _run_torch_sh(tsv, teacher_ckpt, exp, tmp_path, NPROC="2")
    assert f"Done: {exp}/dphubert.pth" in proc.stdout
    model = model_from_checkpoint(load_checkpoint(exp / "dphubert.pth"), device="cpu")
    with torch.inference_mode():
        outs, _ = model.extract_features(torch.zeros(1, 32000))
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    for stage, steps in (("stage1", 3), ("stage2", 2)):
        rows = (exp / stage / "metrics.jsonl").read_text().splitlines()
        assert len(rows) == steps, (stage, rows)
        ckpt = torch.load(exp / stage / "ckpts" / "rotated" / f"step_{steps}.pt",
                          weights_only=True)
        assert ckpt["meta"]["layout"] == [2, 1]
        assert not (exp / stage / "exit_code").exists()
