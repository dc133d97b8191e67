"""Training loop: epochs, the feed, logging, checkpoint/resume, validation
and the stage export (the TPU package's ``train/trainer.py``), on one card
or on a (data x model) mesh of processes.

``train`` runs stage 1 (``cfg.use_reg``: gates and the Lagrangian) or the
final distill (``use_reg=False``, projections warm-started from stage 1) to
``cfg.max_updates`` optimizer updates:

* the loader's batches (and their lengths) go to the card one dispatch
  ahead, from pinned host memory with a non-blocking copy;
* ``steps_per_dispatch=K`` groups K consecutive batches of one shape
  (``_group_iter``; the batcher's ``run_length=K`` forms such runs) into
  one call of ``make_train_step(..., steps_per_call=K)``, a CUDA graph of K
  steps on the card; shape changes, epoch tails and the last steps before
  ``max_updates`` run as single steps, and the run ends exactly at
  ``max_updates``;
* a checkpoint (``train/checkpointing.py``) is written when the micro-step
  count crosses a multiple of ``ckpt_interval``, at the end, and when the
  run stops early: ``ckpts/last.pt`` (``ckpt_backend="last"``) or the
  newest ``ckpt_keep`` of ``ckpts/rotated/step_{n}.pt`` ("rotated");
  by default through the background saver, which copies the state on
  the card and writes it from a thread (``DPHUBERT_SYNC_CKPT=1``, or a
  state too large for the card's spare memory, writes synchronously);
  ``resume`` (a file, or the rotated directory: its newest) continues at
  the exact batch, gate draw and dropout mask;
* validation runs at each epoch end, every ``val_interval`` micro-steps,
  and once on the final state of a completed run;
* a SIGTERM, ``stop_at_step``, the RSS watchdog (the process's resident
  memory past ``DPHUBERT_MAX_RSS_GB``, read every 100 steps) or the
  wall-clock deadline ``DPHUBERT_DEADLINE_TS`` (unix seconds) checkpoints
  and stops; the reason is returned through ``stop_info["why"]``
  ("sigterm", "stop_at_step", "rss watchdog", "deadline"), from which the
  CLIs choose their exit codes.

On a mesh (``train(..., mesh=...)``, ``parallel/``): every rank feeds its
rows of each global batch (the loader's ``shard``), the step averages the
gradients over the data group, the audio-seconds logged count the global
batch, and a stop decided on any rank (SIGTERM, watchdog, deadline) is
agreed by all at the dispatch boundary (one small all-reduce on the host,
so no rank enters a collective the others have left).  With ``fsdp`` the
student, its projections, their Adam moments and the frozen teacher are
split over the data group as well (``parallel/fsdp.py``; with a model
group, HSDP).  Rank 0 logs, prints the validation loss (every rank runs its
rows; the loss is averaged) and writes the checkpoints, which hold the
one-card state (a run that splits tensors gathers them first, on every
rank); every rank passes a barrier once the last one is written.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..interop.torch_ckpt import save_checkpoint
from ..models.gates import compile_gates, has_gates
from ..models.model import Wav2Vec2Model, resolve_device
from ..parallel.fsdp import shard_module
from ..parallel.mesh import agree_max, barrier, replicate
from ..parallel.sharding import gather_full, gather_state_tensors
from ..params import unflatten_params
from ..utils.profiling import span
from .checkpointing import (
    BackgroundSaver,
    RotatingCheckpointer,
    background_ckpt_fits,
    load_train_state,
    save_train_state,
)
from .distill_module import (
    DistillConfig,
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    param_tree,
    refuse_gloo_graphs,
)
from .projections import projections_from_state_dict, projections_to_state_dict

SAMPLE_RATE = 16000
RSS_CHECK_INTERVAL = 100  # steps between two reads of /proc/self/statm
CKPT_BACKENDS = ("last", "rotated")
# a stop's reason, by priority: the ranks agree on the largest code
STOPS = (None, "stop_at_step", "sigterm", "rss watchdog", "deadline")


def _memory_budget_bytes() -> int:
    """The RSS watchdog's memory budget: the smaller of the host's physical
    RAM and the cgroup limit (in a container the OOM killer fires at the
    cgroup limit, often far below the host's RAM); 0 if neither is known."""
    budgets = []
    try:
        budgets.append(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        pass
    for p in ("/sys/fs/cgroup/memory.max",  # cgroup v2
              "/sys/fs/cgroup/memory/memory.limit_in_bytes"):  # cgroup v1
        try:
            with open(p) as f:
                text = f.read().strip()
            if text != "max":
                budgets.append(int(text))
        except (OSError, ValueError):
            pass
    return min(budgets) if budgets else 0


def rss_limit_bytes() -> int:
    """``DPHUBERT_MAX_RSS_GB`` (GB of 1e9 bytes; 0 disables the watchdog),
    else 0.85 of ``_memory_budget_bytes``."""
    limit = os.environ.get("DPHUBERT_MAX_RSS_GB")
    if limit is not None:
        return int(float(limit) * 1e9)
    return int(_memory_budget_bytes() * 0.85)


def _rss_bytes() -> Optional[int]:
    """The process's resident set size, from /proc/self/statm."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class MetricLogger:
    """stdout + JSONL metrics log (the reference logs via Lightning's
    log_dict every ``log_interval`` steps, distill.py:49).  Metric values
    are read from the card only on the steps that are logged."""

    def __init__(self, exp_dir: pathlib.Path, interval: int = 50, enabled: bool = True):
        self.interval = interval
        self.enabled = enabled  # rank 0 of a mesh logs, the others count
        self.path = exp_dir / "metrics.jsonl"
        self._f = open(self.path, "a") if enabled else None
        self._t0 = time.time()
        self._last_step = 0
        self._last_time = self._t0
        self._audio_acc = 0.0

    def log(self, step: int, metrics: dict, audio_seconds: float = 0.0):
        self._audio_acc += audio_seconds
        if step % self.interval != 0 or not self.enabled:
            return
        now = time.time()
        dt = now - self._last_time
        row = {
            "step": step,
            "elapsed": round(now - self._t0, 1),
            "steps_per_sec": round((step - self._last_step) / dt, 3) if dt > 0 else 0,
            "audio_sec_per_sec": round(self._audio_acc / dt, 1) if dt > 0 else 0,
            **{k: float(v) for k, v in metrics.items()},
        }
        self._last_step, self._last_time, self._audio_acc = step, now, 0.0
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        msg = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()
        )
        print(f"[train] {msg}", flush=True)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def train(
    *,
    teacher: Wav2Vec2Model,
    student: Wav2Vec2Model,
    cfg: DistillConfig,
    loader,
    exp_dir,
    valid_loader=None,
    log_interval: int = 50,
    ckpt_interval: int = 1000,
    resume: Optional[str] = None,
    seed: int = 2022,
    proj_state_dict=None,
    stop_at_step: Optional[int] = None,
    val_interval: Optional[int] = None,
    stop_info: Optional[dict] = None,
    steps_per_dispatch: int = 1,
    ckpt_backend: str = "last",
    ckpt_keep: int = 3,
    device="cuda",
    mesh=None,
    fsdp: bool = False,
) -> TrainState:
    """Train a copy of ``student`` against the frozen ``teacher`` (a module
    on ``device``) to ``cfg.max_updates`` updates; returns the final state.
    On a ``mesh`` every rank calls it with the same arguments, except the
    loaders, which yield this rank's rows; the teacher and the student take
    rank 0's weights, and with ``fsdp`` both are split over the data group
    (the teacher in place).

    ``loader`` and ``valid_loader`` have ``epoch(e, skip=0)`` yielding
    ``(waveforms, lengths)`` numpy batches (``DistillDataLoader``).
    ``proj_state_dict`` warm-starts the projections (reference
    final_distill.py:93).  ``stop_at_step`` stops at the first dispatch
    boundary at or past it."""
    device = resolve_device(device)
    if ckpt_backend not in CKPT_BACKENDS:
        raise ValueError(f"ckpt_backend must be one of {CKPT_BACKENDS}, got {ckpt_backend!r}")
    K = max(int(steps_per_dispatch), 1)
    refuse_gloo_graphs(mesh, K, device)
    is_main = mesh is None or mesh.is_main
    exp_dir = pathlib.Path(exp_dir)
    if is_main:
        (exp_dir / "ckpts").mkdir(parents=True, exist_ok=True)
    accum = max(cfg.accum_grad, 1)
    n_data = 1 if mesh is None else mesh.n_data
    layout = (n_data, 1 if mesh is None else mesh.n_model)

    projs = None
    if proj_state_dict is not None:
        # warm-started projections (reference final_distill.py:93), placed on
        # the mesh with the rest of the state
        projs = projections_from_state_dict(proj_state_dict, cfg.distill_mode,
                                            cfg.distill_layer_groups, device=device)
    if mesh is not None:
        replicate(teacher, mesh)
        if fsdp:
            shard_module(teacher, mesh)
    state, tx = init_train_state(student=student, cfg=cfg,
                                 teacher_embed_dim=teacher.spec.embed_dim, seed=seed,
                                 device=device, mesh=mesh, fsdp=fsdp, projs=projs)

    rotated = None
    if ckpt_backend == "rotated":
        rotated = RotatingCheckpointer(exp_dir / "ckpts" / "rotated", keep=ckpt_keep,
                                       create=is_main)

    resume_pos = (0, 0)  # (epoch, batches already consumed in that epoch)
    if resume:
        resume_pos = load_train_state(resume, state, accum_grad=accum, steps_per_dispatch=K)
        print(f"[train] resumed from {resume} at step {state.step} "
              f"(epoch {resume_pos[0]}, batch {resume_pos[1]})", flush=True)

    # SIGTERM checkpoints the full training state before the process exits
    # (the reference relies on manual --resume_checkpoint only)
    stop_requested = {"flag": False}

    def _on_sigterm(signum, frame):
        stop_requested["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread
        prev_handler = None

    # wall-clock deadline: DPHUBERT_DEADLINE_TS (unix seconds) turns a hard
    # end time into a clean checkpoint-and-stop; the CLIs exit 76 on it (75
    # for preemption), so a recipe script does not resume into the same
    # deadline.  0 or unset disables it.
    deadline_ts = float(os.environ.get("DPHUBERT_DEADLINE_TS", 0) or 0)

    # RSS watchdog: a host-memory leak ends in the OOM killer's SIGKILL
    # mid-step, losing everything since the last checkpoint; past the limit
    # the run checkpoints and stops instead (the CLIs exit 75, which the
    # recipe script resumes).  Read every RSS_CHECK_INTERVAL steps, counted
    # from 0 in each process, so a resumed run reads at its first step.
    rss_limit = rss_limit_bytes()
    rss_last_check = 0

    def _rss_exceeded(step: int) -> bool:
        nonlocal rss_last_check
        if not rss_limit or step - rss_last_check < RSS_CHECK_INTERVAL:
            return False
        rss_last_check = step
        rss = _rss_bytes()
        if rss is None or rss <= rss_limit:
            return False
        print(f"[train] rss {rss / 1e9:.1f} GB > limit {rss_limit / 1e9:.1f} GB: "
              "checkpointing and exiting (resumable)", flush=True)
        return True

    logger = MetricLogger(exp_dir, log_interval, enabled=is_main)
    step_fn = make_train_step(teacher, cfg, tx, mesh=mesh)
    multi_fn = (make_train_step(teacher, cfg, tx, steps_per_call=K, mesh=mesh)
                if K > 1 else None)
    eval_fn = make_eval_step(teacher, cfg) if valid_loader is not None else None

    max_micro_steps = cfg.max_updates * accum
    step = state.step
    epoch, skip = resume_pos
    batch_in_epoch = skip
    done = False
    last_val_step = -1
    # a rotated step is written once: seeded from the directory (rank 0's
    # reading, agreed by all: every rank must take the same checkpoints), so
    # a resumed run's first save cannot land on a step already on disk
    latest = -1
    if rotated is not None and is_main and rotated.latest_step() is not None:
        latest = rotated.latest_step()
    last_saved = {"step": agree_max(latest, mesh)}
    why = None

    def _tensors():
        """The one-card tensors of a state split on the mesh (a collective:
        every rank calls it); None where the state is whole."""
        return gather_state_tensors(state) if state.shards else None

    def _write_ckpt(snap, *, step, epoch, batch_in_epoch, tensors=None):
        """The backend's write of a ``TrainState`` (synchronous path) or a
        host snapshot (background path)."""
        kw = dict(epoch=epoch, batch_in_epoch=batch_in_epoch, accum_grad=accum,
                  steps_per_dispatch=K, layout=layout, tensors=tensors)
        if rotated is not None:
            rotated.save(step, snap, **kw)
        else:
            save_train_state(exp_dir / "ckpts" / "last.pt", snap, **kw)

    saver = None
    # the snapshot is one more copy of the state on the card while training
    # goes on: a state too large for that (or DPHUBERT_SYNC_CKPT=1) stays
    # synchronous; rank 0 alone writes
    full = _tensors()
    if is_main and background_ckpt_fits(state, tensors=full):
        saver = BackgroundSaver(_write_ckpt)
        saver.reserve(state, full)
        if multi_fn is not None:
            multi_fn.before_capture = saver.wait
    elif is_main:
        logging.getLogger("dphubert_torch").info(
            "background checkpoints off (DPHUBERT_SYNC_CKPT, DPHUBERT_BG_CKPT, or a state "
            "too large for the card's spare memory): saving synchronously")

    del full

    def _checkpoint():
        if step == last_saved["step"]:
            return
        last_saved["step"] = step
        tensors = _tensors()
        if not is_main:
            return
        kw = dict(step=step, epoch=epoch, batch_in_epoch=batch_in_epoch)
        if saver is not None:
            saver.submit(state, tensors, **kw)
        else:
            _write_ckpt(state, tensors=tensors, **kw)

    def _validate():
        _run_validation(eval_fn, state, valid_loader, step, mesh)

    def _log_dispatch(prev_step: int, n: int, metrics: dict, audio_sec: float):
        """Log each micro-step of an n-step dispatch; stacked metrics are
        read from the card in one transfer, and only when a logged step
        falls inside the dispatch."""
        if n == 1:
            metrics["updates"] = (prev_step + 1) // accum
            logger.log(prev_step + 1, metrics, audio_seconds=audio_sec)
            return
        need = logger.enabled and any((prev_step + 1 + j) % logger.interval == 0
                                      for j in range(n))
        rows = None
        if need:
            names = list(metrics)
            rows = dict(zip(names, torch.stack([metrics[k] for k in names]).cpu().numpy()))
        for j in range(n):
            ms = prev_step + 1 + j
            row = {}
            if rows is not None:
                row = {k: v[j] for k, v in rows.items()}
                row["updates"] = ms // accum
            logger.log(ms, row, audio_seconds=audio_sec / n)

    try:
        while not done:
            epoch_yielded = 0
            groups = _group_iter(_epoch_iter(loader, epoch, skip), K,
                                 lambda: max_micro_steps - step)
            for wave, lengths, audio_sec in _device_prefetch(groups, device):
                audio_sec *= n_data  # the global batch's
                n = wave.shape[0] if wave.dim() == 3 else 1
                if n > 1 and step + n > max_micro_steps:
                    # the grouper's remaining() guard ran one dispatch early
                    # (the prefetch runs ahead): take only the steps that
                    # fit, one at a time, so the run ends exactly at
                    # max_updates and batch_in_epoch counts what was taken
                    for j in range(max_micro_steps - step):
                        lj = None if lengths is None else lengths[j]
                        state, metrics = step_fn(state, (wave[j], lj))
                        epoch_yielded += 1
                        step += 1
                        batch_in_epoch += 1
                        _log_dispatch(step - 1, 1, metrics, audio_sec / n)
                    done = True
                    break
                if n > 1:
                    state, metrics = multi_fn(state, (wave, lengths))
                else:
                    state, metrics = step_fn(state, (wave, lengths))
                epoch_yielded += n
                prev_step = step
                step += n
                batch_in_epoch += n
                _log_dispatch(prev_step, n, metrics, audio_sec)
                if step // ckpt_interval > prev_step // ckpt_interval:
                    _checkpoint()
                # at train960 scale one epoch is tens of thousands of steps,
                # so validation also fires every val_interval steps
                if (eval_fn is not None and val_interval
                        and step // val_interval > prev_step // val_interval):
                    _validate()
                    last_val_step = step
                # with K > 1 a stop lands on the dispatch boundary
                if stop_requested["flag"]:
                    why = "sigterm"
                elif stop_at_step is not None and prev_step < stop_at_step <= step:
                    why = "stop_at_step"
                elif _rss_exceeded(step):
                    why = "rss watchdog"
                elif deadline_ts and time.time() >= deadline_ts:
                    why = "deadline"
                if mesh is not None:
                    why = STOPS[agree_max(STOPS.index(why), mesh)]
                if why:
                    _checkpoint()
                    print(f"[train] preempted ({why}): checkpointed at step {step}, "
                          "exiting", flush=True)
                    done = True
                    break
                if step >= max_micro_steps:
                    done = True
                    break
            if done:
                break  # keep (epoch, batch_in_epoch) for the final checkpoint
            if epoch_yielded == 0 and skip == 0:
                # an epoch with nothing skipped and nothing yielded would spin
                # forever: the corpus cannot fill one batch at any rung
                raise RuntimeError(
                    f"loader produced no batches in epoch {epoch}: corpus too "
                    "small for the configured seconds_per_batch"
                )
            if eval_fn is not None:
                _validate()
                last_val_step = step
            epoch += 1
            skip = 0
            batch_in_epoch = 0

        # validate once on the final state of a completed run, even when it
        # ends mid-epoch (a preempted run skips this: it will resume)
        if eval_fn is not None and why is None and step > 0 and last_val_step != step:
            _validate()
        _checkpoint()
        if saver is not None:
            err = saver.close()  # wait for the write in flight
            saver = None
            if err is not None:
                # the final checkpoint has no successor to supersede it:
                # rewrite it from the live state
                logging.getLogger("dphubert_torch").warning(
                    "final background checkpoint save failed (%s: %s); rewriting "
                    "synchronously", type(err).__name__, err)
                _write_ckpt(state, step=step, epoch=epoch, batch_in_epoch=batch_in_epoch,
                            tensors=_tensors())
        barrier(mesh)  # the last checkpoint is on disk for every rank
    finally:
        if saver is not None:  # an exception ended the run
            saver.close()
        logger.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    if stop_info is not None:
        stop_info["why"] = why
    return state


def _group_iter(it, k: int, remaining):
    """Stack runs of ``k`` consecutive same-shape batches into one
    (k, B, T) feed for a multi-step dispatch; shape changes, epoch tails,
    and the last < k steps before ``remaining()`` runs out flush as
    single batches.  Pair the batcher's ``run_length=k`` with this so
    runs actually form (a plain shuffled epoch interleaves shapes).  A
    copy of the TPU package's."""
    if k <= 1:
        yield from it
        return
    pend = []

    def _flush_single(p):
        for w, l in p:
            yield w, l

    for wave, lengths in it:
        if pend and (pend[0][0].shape != wave.shape
                     or (pend[0][1] is None) != (lengths is None)):
            yield from _flush_single(pend)
            pend = []
        pend.append((wave, lengths))
        if len(pend) == k:
            if remaining() < k:  # don't overshoot max_updates
                yield from _flush_single(pend)
            else:
                yield (
                    np.stack([w for w, _ in pend]),
                    (np.stack([l for _, l in pend])
                     if pend[0][1] is not None else None),
                )
            pend = []
    yield from _flush_single(pend)


def _device_prefetch(it, device: torch.device):
    """Run one dispatch ahead: the host-to-card copies of dispatch N+1's
    batch and lengths (from pinned memory, non-blocking) are issued before
    dispatch N runs.  Yields (waveforms on the device, lengths on the
    device or None, audio seconds).  Under a profiler each batch's copies
    are a ``feed.h2d`` range, closed before the yield."""
    prev = None
    for wave, lengths in it:
        with span("feed.h2d"):
            audio_sec = wave.size / SAMPLE_RATE
            t = torch.from_numpy(wave)
            lens = None if lengths is None else torch.from_numpy(np.asarray(lengths, np.int32))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
                if lens is not None:
                    lens = lens.pin_memory().to(device, non_blocking=True)
        cur = (t, lens, audio_sec)
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev


def _epoch_iter(loader, epoch: int, skip: int):
    """loader.epoch with a resume skip; loaders without ``skip`` support
    (e.g. test doubles) fall back to iterate-and-drop."""
    if not skip:
        return loader.epoch(epoch)
    try:
        return loader.epoch(epoch, skip=skip)
    except TypeError:
        it = loader.epoch(epoch)
        for _ in range(skip):
            next(it, None)
        return it


def _run_validation(eval_fn, state: TrainState, valid_loader, step: int, mesh=None) -> None:
    """Mean validation loss with the compiled eval gates, read from the
    card once at the end; on a mesh every rank runs its rows, the mean is
    averaged over the data group and rank 0 prints it."""
    gates = None
    if has_gates(state.student.spec):
        gates = compile_gates(state.student.spec, param_tree(state)["student"])
    losses = [eval_fn(state, (wave, lengths), gates)["loss"]
              for wave, lengths in valid_loader.epoch(0)]
    if mesh is not None and not mesh.is_main:
        if losses:
            _data_mean(torch.stack(losses).float().mean(), mesh)
        return
    if losses:
        mean = _data_mean(torch.stack(losses).float().mean(), mesh).item()
        print(f"[valid] step={step} loss={mean:.4f} ({len(losses)} batches)", flush=True)
    else:
        print(f"[valid] step={step} skipped: validation set too small "
              "to fill one batch", flush=True)


def _data_mean(value: torch.Tensor, mesh) -> torch.Tensor:
    """A 0-dim tensor averaged over the mesh's data group."""
    if mesh is None or mesh.n_data == 1:
        return value
    from ..parallel.comm import sum_over

    return sum_over(value, mesh.data_group) / mesh.n_data


def export_student_checkpoint(state: TrainState, cfg: DistillConfig, path) -> None:
    """Write the stage output as a portable ``{config, state_dict,
    distill_linear_projs}`` checkpoint, the input of the prune and export
    CLIs (and of the reference's tooling, through the .pth format).  On a
    mesh every rank calls it (a split student is gathered first)
    and rank 0 writes."""
    whole = gather_full(state)
    if state.mesh is not None and not state.mesh.is_main:
        return
    sd = {k[len("student."):]: v.cpu().numpy() for k, v in whole.items()
          if k.startswith("student.")}
    projs = unflatten_params({k[len("projs."):]: v for k, v in whole.items()
                              if k.startswith("projs.")})
    projs = projections_to_state_dict(projs, cfg.distill_mode, cfg.distill_layer_groups)
    save_checkpoint(path, state.student.config, sd, projs)
