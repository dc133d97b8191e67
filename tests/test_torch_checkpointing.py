"""The port's checkpoint backends (``train/checkpointing.py``): the rotated
step files, the background saver and its size gate, and the trainer's
resume through them (the counterparts of ``tests/test_checkpointing.py``
and the trainer-feature tests of the TPU package).

The ``gpu`` tests run the saver's device snapshot and side-stream copy on
the card (``python -m pytest --noconftest -m gpu
tests/test_torch_checkpointing.py``)."""

import logging

import numpy as np
import pytest
import torch

from dphubert_torch.train import init_train_state, make_train_step
from dphubert_torch.train import checkpointing as ck
from dphubert_torch.train import trainer as t_trainer

# a plain import of the sibling module (pytest puts tests/ on the path):
# the card's machine may have another package named ``tests``
from test_torch_dispatch import (  # noqa: F401 (fixture)
    _card,
    assert_same_state,
    deterministic,
    config,
    models,
    one_torch_thread,
    run,
)


def _state(seed=0, device="cpu", steps=0, cfg=None):
    """A state after ``steps`` steps on fixed batches (dropout and gates
    on), so the moments and the generator are not at their start."""
    cfg = cfg or config()
    teacher, student = models(device)
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=128, seed=seed,
                                 device=device)
    step = make_train_step(teacher, cfg, tx)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        state, _ = step(state, ((0.1 * rng.standard_normal((2, 3200))).astype(np.float32),
                                None))
    return state, step


def _bump(state):
    """Move every tensor of the state in place, as a training step would."""
    with torch.no_grad():
        for t in ck._state_tensors(state).values():
            t.add_(1.0)
    state.step += 1
    state.generator.manual_seed(state.step)


def _host_tensors(state):
    return {k: v.detach().cpu().clone() for k, v in ck._state_tensors(state).items()}


def test_rotated_save_and_restore_are_exact(tmp_path):
    state, _ = _state(steps=2)
    mgr = ck.RotatingCheckpointer(tmp_path / "rot", keep=2)
    mgr.save(2, state, epoch=3, batch_in_epoch=41, steps_per_dispatch=4)
    fresh, _ = _state(seed=9)
    assert ck.load_train_state(mgr.path(2), fresh, steps_per_dispatch=4) == (3, 41)
    assert_same_state(state, fresh)
    # a directory resumes from its newest file, and an empty one is an error
    mgr.save(3, state, epoch=4, batch_in_epoch=2, steps_per_dispatch=4)
    fresh2, _ = _state(seed=8)
    assert ck.load_train_state(tmp_path / "rot", fresh2, steps_per_dispatch=4) == (4, 2)
    assert_same_state(state, fresh2)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.load_train_state(tmp_path / "empty", fresh2)


def test_rotation_keeps_the_last_n_and_saves_a_step_once(tmp_path):
    state, _ = _state()
    mgr = ck.RotatingCheckpointer(tmp_path / "rot", keep=2)
    for s in (1, 2, 3, 4, 5):
        state.step = s
        mgr.save(s, state)
    assert mgr.steps() == [4, 5] and mgr.latest_step() == 5
    assert sorted(p.name for p in (tmp_path / "rot").iterdir()) == ["step_4.pt", "step_5.pt"]
    state.step = 99
    mgr.save(5, state)  # already on disk: nothing is written
    assert torch.load(mgr.path(5), weights_only=True)["step"] == 5
    with pytest.raises(ValueError, match="keep"):
        ck.RotatingCheckpointer(tmp_path / "x", keep=0)


def test_background_saver_captures_the_state_at_submit(tmp_path):
    """``submit`` returns before the write; what the writer gets is the
    state as of ``submit``, bit for bit, though the live state moves right
    after; and the files it writes resume to that state."""
    state, _ = _state(steps=1)
    recorded, expected = {}, {}

    def save_fn(snap, *, step):
        recorded[step] = snap
        ck.save_train_state(tmp_path / f"s{step}.pt", snap)

    saver = ck.BackgroundSaver(save_fn)
    for s in (1, 2):
        expected[s] = (_host_tensors(state), state.generator.get_state(), state.step)
        saver.submit(state, step=s)
        _bump(state)
    saver.wait()
    assert not saver.in_flight()
    assert saver.close() is None
    assert sorted(recorded) == [1, 2]
    for s in (1, 2):
        tensors, gen, step = expected[s]
        assert recorded[s].step == step and torch.equal(recorded[s].generator, gen)
        got = recorded[s].tensors
        for k, v in tensors.items():
            assert torch.equal(got[k], v), (s, k)
        ckpt = torch.load(tmp_path / f"s{s}.pt", weights_only=True)
        for k, v in ckpt["params"].items():
            assert torch.equal(v, tensors[f"params/{k}"]), (s, k)


def test_background_saver_degrades_to_sync_on_a_writer_failure(caplog):
    """A failed background save does not end the run: the next submit
    saves synchronously from the live state (so later checkpoints still
    land) and so do all after it; a failure of the last save comes back
    from ``close`` for the trainer to rewrite."""
    calls = []

    def flaky(snap, *, step):
        calls.append(step)
        if len(calls) == 1:
            raise MemoryError("simulated out of memory")

    state, _ = _state()
    saver = ck.BackgroundSaver(flaky)
    saver.submit(state, step=1)  # in the writer; it fails
    with caplog.at_level(logging.WARNING, logger="dphubert_torch"):
        saver.submit(state, step=2)  # sees the failure: synchronous
    assert saver._degraded and "synchronously" in caplog.text
    saver.submit(state, step=3)  # stays synchronous
    assert saver.close() is None
    assert calls == [1, 2, 3]

    failing = ck.BackgroundSaver(lambda snap, **kw: 1 / 0)
    failing.submit(state, step=7)
    assert isinstance(failing.close(), ZeroDivisionError)


def test_trainer_rewrites_a_failed_final_background_save(tmp_path, monkeypatch):
    """The final checkpoint has no successor: when its background write
    fails, the trainer writes it again synchronously from the live state."""
    real = ck.save_train_state
    attempts = []

    def fail_first(path, state, **kw):
        attempts.append(type(state).__name__)
        if len(attempts) == 1:
            raise OSError("simulated disk error")
        real(path, state, **kw)

    monkeypatch.setattr(t_trainer, "save_train_state", fail_first)
    state = run(tmp_path, cfg=config(max_updates=3))
    assert attempts == ["Snapshot", "TrainState"]
    ckpt = torch.load(tmp_path / "ckpts" / "last.pt", weights_only=True)
    assert ckpt["step"] == state.step == 3


def test_background_ckpt_size_gate(monkeypatch):
    """A snapshot past 15% of the card's memory stays synchronous; the
    card's total comes from ``torch.cuda.mem_get_info``, 2 GiB where there
    is none; ``DPHUBERT_BG_CKPT`` overrides."""
    monkeypatch.delenv("DPHUBERT_BG_CKPT", raising=False)
    monkeypatch.delenv("DPHUBERT_SYNC_CKPT", raising=False)
    small, _ = _state()
    assert ck.background_ckpt_fits(small)  # CPU: the 2 GiB cap

    class Big:
        nbytes = 3 * 1024**3

    totals = []

    def mem_get_info(device=None):
        totals.append(device)
        return (1 * 1024**3, 16 * 1024**3)  # 15% of 16 GiB = 2.4 GiB

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert not ck.background_ckpt_fits([Big()], device="cuda")
    assert totals == ["cuda"]
    assert not ck.background_ckpt_fits([Big()])  # no card: the 2 GiB cap
    Big.nbytes = 2 * 1024**3
    assert ck.background_ckpt_fits([Big()], device="cuda")
    assert not ck.background_ckpt_fits([Big(), Big()], device="cuda")
    monkeypatch.setenv("DPHUBERT_BG_CKPT", "1")
    assert ck.background_ckpt_fits([Big(), Big()], device="cuda")
    monkeypatch.setenv("DPHUBERT_BG_CKPT", "0")
    assert not ck.background_ckpt_fits(small)
    # the TPU package's switch: DPHUBERT_SYNC_CKPT=1 is DPHUBERT_BG_CKPT=0
    monkeypatch.setenv("DPHUBERT_BG_CKPT", "1")
    monkeypatch.setenv("DPHUBERT_SYNC_CKPT", "1")
    assert not ck.background_ckpt_fits(small)
    monkeypatch.setenv("DPHUBERT_SYNC_CKPT", "0")
    assert ck.background_ckpt_fits(small)
    assert ck.snapshot_bytes(small) == sum(
        t.numel() * 4 for t in ck._state_tensors(small).values())


def test_steps_per_dispatch_missing_metadata_treated_as_one():
    ck.check_steps_per_dispatch({}, "old.pt", 1)
    ck.check_steps_per_dispatch({"steps_per_dispatch": 4}, "new.pt", 4)
    with pytest.raises(ValueError, match="steps_per_dispatch=1"):
        ck.check_steps_per_dispatch({}, "old.pt", 4)
    with pytest.raises(ValueError, match="--steps_per_dispatch 4"):
        ck.check_steps_per_dispatch({"steps_per_dispatch": 4}, "new.pt", 2)


@pytest.mark.parametrize("sync", ["0", "1"])
def test_preempted_rotated_run_resumes_bit_for_bit(tmp_path, monkeypatch, sync):
    """Stage 1 (gates and dropout on) with ``ckpt_backend="rotated"``,
    keep 2, a checkpoint every 2 steps, K = 2, background (and, with
    ``DPHUBERT_SYNC_CKPT=1``, synchronous) writes: stopped at step 4 and
    resumed from the directory to step 6, it equals the uninterrupted run
    bit for bit; the directory keeps the newest two steps."""
    monkeypatch.setenv("DPHUBERT_SYNC_CKPT", sync)
    kw = dict(steps_per_dispatch=2, ckpt_backend="rotated", ckpt_keep=2, ckpt_interval=2)
    monkeypatch.setattr(t_trainer, "BackgroundSaver", _counting_saver(sync))
    full = run(tmp_path / "full", **kw)
    rot = tmp_path / "full" / "ckpts" / "rotated"
    assert sorted(p.name for p in rot.iterdir()) == ["step_4.pt", "step_6.pt"]
    part = run(tmp_path / "part", stop_at_step=4, **kw)
    assert part.step == 4
    resumed = run(tmp_path / "part", resume=tmp_path / "part" / "ckpts" / "rotated", **kw)
    assert resumed.step == full.step == 6
    assert_same_state(full, resumed)
    assert ck.RotatingCheckpointer(tmp_path / "part" / "ckpts" / "rotated").steps() == [4, 6]
    assert _counting_saver.made == (0 if sync == "1" else 3)


def _counting_saver(sync):
    _counting_saver.made = 0

    class Counting(ck.BackgroundSaver):
        def __init__(self, save_fn):
            _counting_saver.made += 1
            super().__init__(save_fn)

    return Counting


@pytest.mark.gpu
def test_background_saver_on_card_captures_the_state_at_submit(tmp_path, deterministic):
    """On the card: the snapshot is taken on the compute stream at
    ``submit``, the steps that follow move the live state while the writer
    copies the snapshot on its side stream, and the file resumes a fresh
    state to the submitted one bit for bit, which then steps on exactly as
    the live run did."""
    _card()
    state, step = _state(device="cuda", steps=2)
    expected = _host_tensors(state)
    gen = state.generator.get_state()
    mgr = ck.RotatingCheckpointer(tmp_path / "rot")
    saver = ck.BackgroundSaver(lambda snap, **kw: mgr.save(snap.step, snap, **kw))
    saver.submit(state, epoch=0, batch_in_epoch=2)
    rng = np.random.default_rng(5)
    batches = [(0.1 * rng.standard_normal((2, 3200))).astype(np.float32) for _ in range(2)]
    for b in batches:
        state, _ = step(state, (b, None))
    assert saver.close() is None
    ckpt = torch.load(mgr.path(2), weights_only=True)
    for k, v in ckpt["params"].items():
        assert torch.equal(v, expected[f"params/{k}"]), k
    assert torch.equal(ckpt["generator"], gen)
    fresh, fresh_step = _state(seed=7, device="cuda")
    ck.load_train_state(mgr.path(2), fresh)
    for b in batches:
        fresh, _ = fresh_step(fresh, (b, None))
    assert_same_state(state, fresh)
