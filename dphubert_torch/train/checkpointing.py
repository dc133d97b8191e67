"""The training-state checkpoint: the last-only file, keep-N rotation and
the background saver (the TPU package's ``train/checkpointing.py`` and the
``npz`` / ``orbax`` backends of its trainer).

A checkpoint is a ``torch.save`` of plain containers and tensors that loads
with ``torch.load(weights_only=True)``:

    {"params":  {name: tensor},          # TrainState.named_params(): the
                                         # student, projections and λs
     "opt":     {"mu": {...}, "nu": {...}, "count": int, "mini_step": int,
                 "acc": {...} or None},   # the three Adam groups' moments
     "step":    int,                      # micro-steps taken
     "generator": uint8 tensor,           # the state's generator (gates and
                                          # dropout), on the card or the CPU
     "epoch": int, "batch_in_epoch": int, # the loader's position
     "meta": {"format": ..., "generator_device": "cuda" | "cpu",
              "accum_grad": int, "steps_per_dispatch": int,
              "layout": [n_data, n_model]}}

so that a resumed run takes exactly the batches, gate draws and dropout
masks an uninterrupted run would.  A checkpoint always holds the one-card
state: a run that splits tensors (tensor parallelism, FSDP, HSDP) gathers
them over the data and the model group on the compute stream before the
snapshot (``parallel.sharding.gather_state_tensors``, passed in as
``tensors``), rank 0 writes, and on resume every rank reads the file and
takes its own block, at any layout (``layout`` is recorded for information
only).  Every file is written to a temporary
name and renamed, so a crash mid-write leaves the previous one whole.

* ``save_train_state`` writes ``ckpts/last.pt`` (the TPU package's
  ``npz`` backend);
* ``RotatingCheckpointer`` writes ``ckpts/rotated/step_{n}.pt`` and keeps
  the newest ``keep`` (its ``orbax`` backend: orbax is not needed, the
  files are the ``last.pt`` format);
* ``BackgroundSaver`` takes the write off the step path: ``submit`` makes
  one device-to-device copy of the state on the compute stream
  (``device_snapshot``) and returns; a writer thread copies it to pinned
  host memory on a side stream and writes it.  ``background_ckpt_fits``
  decides whether the card has room for that copy.

The TPU package's ``_paced_gather`` (a leaf-serial gather that kept a
remote TPU link free for the training feed) is not ported: the snapshot
moves to the host over local PCIe in a few large copies (ROADMAP).
"""

from __future__ import annotations

import logging
import os
import pathlib
import queue
import re
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.sharding import narrow
from .distill_module import TrainState

FORMAT = "dphubert_torch train state 1"
BG_CKPT_SHARE = 0.15  # of the card's memory a background snapshot may take
BG_CKPT_CAP_BYTES = 2 * 1024**3  # where the card's memory is not known


@dataclass
class Snapshot:
    """The training state at one micro-step: its tensors as slices of a
    few flat buffers (``layout``: name, buffer, offset, shape; names carry
    ``params/``, ``mu/``, ``nu/``, ``acc/``), the host counters and the
    generator's state."""

    flats: List[torch.Tensor]
    layout: List[Tuple[str, int, int, torch.Size]]
    step: int
    count: int
    mini_step: int
    generator: torch.Tensor
    generator_device: str

    @property
    def tensors(self) -> Dict[str, torch.Tensor]:
        return {name: self.flats[i][off:off + shape.numel()].view(shape)
                for name, i, off, shape in self.layout}

    def with_flats(self, flats: List[torch.Tensor]) -> "Snapshot":
        return Snapshot(flats, self.layout, self.step, self.count, self.mini_step,
                        self.generator, self.generator_device)


def _state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    opt = state.opt_state
    out = {f"params/{k}": v.detach() for k, v in state.named_params().items()}
    for group in ("mu", "nu", "acc"):
        for k, v in (getattr(opt, group) or {}).items():
            out[f"{group}/{k}"] = v
    return out


def _snapshot(state: TrainState, flats, layout) -> Snapshot:
    opt = state.opt_state
    return Snapshot(flats, layout, int(state.step), int(opt.count), int(opt.mini_step),
                    state.generator.get_state(), state.generator.device.type)


def host_snapshot(state: TrainState, tensors: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Snapshot:
    """The state copied to the host, tensor by tensor (the synchronous
    path: no second copy of the state on the card); ``tensors`` replaces
    the state's own (the one-card tensors of a state split on a mesh)."""
    live = _state_tensors(state) if tensors is None else tensors
    flats = [t.reshape(-1).to("cpu", copy=True) for t in live.values()]
    layout = [(name, i, 0, t.shape) for i, (name, t) in enumerate(live.items())]
    return _snapshot(state, flats, layout)


@torch.no_grad()
def device_snapshot(state: TrainState, tensors: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Snapshot:
    """A copy of the state on its own device: one concatenation per dtype,
    on the current stream, so it holds the state as of this call whatever
    the steps enqueued after it do (``tensors`` as ``host_snapshot``)."""
    live = _state_tensors(state) if tensors is None else tensors
    groups: Dict[torch.dtype, list] = {}
    for name, t in live.items():
        groups.setdefault(t.dtype, []).append(name)
    flats, layout = [], []
    for i, names in enumerate(groups.values()):
        flats.append(torch.cat([live[n].reshape(-1) for n in names]))
        offset = 0
        for n in names:
            layout.append((n, i, offset, live[n].shape))
            offset += live[n].numel()
    return _snapshot(state, flats, layout)


def _pinned(pinned: Optional[dict], dtype: torch.dtype, numel: int) -> torch.Tensor:
    """A pinned host buffer of ``numel`` elements, reused from ``pinned``
    (keyed by dtype and size) where one is there."""
    key = (dtype, int(numel))
    buf = None if pinned is None else pinned.get(key)
    if buf is None:
        buf = torch.empty(int(numel), dtype=dtype, pin_memory=True)
        if pinned is not None:
            pinned[key] = buf
    return buf


def snapshot_to_host(snap: Snapshot, stream: Optional["torch.cuda.Stream"] = None,
                     ready: Optional["torch.cuda.Event"] = None,
                     pinned: Optional[dict] = None) -> Snapshot:
    """A device snapshot copied into pinned host memory, one copy per
    buffer; on the card the copies run on ``stream`` behind the event
    ``ready`` (recorded where the snapshot was taken), and this call
    returns once they have landed.  ``pinned`` holds buffers to reuse
    (``BackgroundSaver.reserve``): pinning a GB of host memory takes
    hundreds of ms and stalls the card's other work meanwhile."""
    if snap.generator_device != "cuda":
        return snap  # already a copy in host memory
    hosts = [_pinned(pinned, f.dtype, f.numel()) for f in snap.flats]
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        for h, f in zip(hosts, snap.flats):
            h.copy_(f, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return snap.with_flats(hosts)


def _payload(snap: Snapshot, *, epoch: int, batch_in_epoch: int, accum_grad: int,
             steps_per_dispatch: int, layout: Tuple[int, int]) -> dict:
    groups: Dict[str, dict] = {"params": {}, "mu": {}, "nu": {}, "acc": {}}
    for name, t in snap.tensors.items():
        group, key = name.split("/", 1)
        groups[group][key] = t
    return {
        "params": groups["params"],
        "opt": {"mu": groups["mu"], "nu": groups["nu"], "count": snap.count,
                "mini_step": snap.mini_step, "acc": groups["acc"] or None},
        "step": snap.step,
        "generator": snap.generator,
        "epoch": int(epoch),
        "batch_in_epoch": int(batch_in_epoch),
        "meta": {"format": FORMAT, "generator_device": snap.generator_device,
                 "accum_grad": int(accum_grad), "steps_per_dispatch": int(steps_per_dispatch),
                 "layout": [int(n) for n in layout]},
    }


def save_train_state(path, state, *, epoch: int = 0, batch_in_epoch: int = 0,
                     accum_grad: int = 1, steps_per_dispatch: int = 1,
                     layout: Tuple[int, int] = (1, 1),
                     tensors: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write the training state (a ``TrainState``, or a ``Snapshot`` on the
    host) and the loader position to ``path``; ``tensors``: the one-card
    tensors of a ``TrainState`` that splits them (``host_snapshot``)."""
    path = pathlib.Path(path)
    snap = state if isinstance(state, Snapshot) else host_snapshot(state, tensors)
    payload = _payload(snap, epoch=epoch, batch_in_epoch=batch_in_epoch,
                       accum_grad=accum_grad, steps_per_dispatch=steps_per_dispatch,
                       layout=layout)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def check_steps_per_dispatch(meta: dict, source, configured: int) -> None:
    """Refuse a resume under another ``steps_per_dispatch`` than the run
    was checkpointed with: the batcher's runs of K reorder the epoch, so
    skipping ``batch_in_epoch`` batches of a differently ordered epoch
    would train some batches twice and others never.  A checkpoint without
    the record was written by a K = 1 trainer."""
    recorded = int(meta.get("steps_per_dispatch", 1))
    if recorded != int(configured):
        raise ValueError(
            f"checkpoint {source} was trained with steps_per_dispatch={recorded} but this "
            f"run configures {int(configured)}; pass --steps_per_dispatch {recorded}")


def _copy_into(dst: dict, src: dict, what: str, shards: dict) -> None:
    """Copy the one-card tensors ``src`` into ``dst``; a split tensor takes
    its block."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: names differ: {sorted(set(dst) ^ set(src))[:8]}")
    for k, t in dst.items():
        src_t = narrow(shards[k], src[k]) if k in shards else src[k]
        t.copy_(src_t.to(t.device, t.dtype))


def resolve_checkpoint(path) -> pathlib.Path:
    """A checkpoint file, or the newest ``step_{n}.pt`` of a directory."""
    path = pathlib.Path(path)
    if not path.is_dir():
        return path
    step = RotatingCheckpointer(path, create=False).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return path / f"step_{step}.pt"


@torch.no_grad()
def load_train_state(path, state: TrainState, *, accum_grad: int = 1,
                     steps_per_dispatch: int = 1) -> Tuple[int, int]:
    """Restore ``path`` (a file, or a directory of rotated checkpoints: its
    newest) into ``state`` in place (parameters, moments, step and
    generator); returns the loader position (epoch, batch_in_epoch).  A
    state on a mesh takes its block of every split tensor, whatever layout
    wrote the file.
    Raises where the checkpoint cannot continue this run: another format,
    a generator of another device type, another ``accum_grad`` or
    ``steps_per_dispatch``."""
    path = resolve_checkpoint(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    meta = ckpt.get("meta", {})
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT!r} checkpoint (meta {meta})")
    if meta["generator_device"] != state.generator.device.type:
        raise ValueError(
            f"{path} holds a {meta['generator_device']} generator, this run has a "
            f"{state.generator.device.type} one: resume on the device that wrote it"
        )
    if meta["accum_grad"] != accum_grad:
        raise ValueError(f"{path} was written with accum_grad={meta['accum_grad']}, "
                         f"this run has {accum_grad}")
    check_steps_per_dispatch(meta, path, steps_per_dispatch)
    state.load_params(ckpt["params"])
    opt = state.opt_state
    _copy_into(opt.mu, ckpt["opt"]["mu"], "Adam first moments", state.shards)
    _copy_into(opt.nu, ckpt["opt"]["nu"], "Adam second moments", state.shards)
    if opt.acc is not None:
        _copy_into(opt.acc, ckpt["opt"]["acc"], "gradient accumulator", state.shards)
    opt.count = int(ckpt["opt"]["count"])
    opt.mini_step = int(ckpt["opt"]["mini_step"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"])
    return int(ckpt["epoch"]), int(ckpt["batch_in_epoch"])


class RotatingCheckpointer:
    """Keep-last-N checkpoints in a directory, ``step_{n}.pt`` each in the
    ``last.pt`` format.  ``save`` of a step already on disk does nothing
    (a resumed run's first save may land on the step it resumed from).
    Every file is whole when ``save`` returns, so there is nothing to
    close; ``load_train_state(directory)`` restores the newest."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory, keep: int = 3, create: bool = True):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = pathlib.Path(directory)
        self.keep = keep
        if create:
            self.directory.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list:
        if not self.directory.is_dir():
            return []
        found = (self._NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> pathlib.Path:
        return self.directory / f"step_{int(step)}.pt"

    def save(self, step: int, state, **kw) -> None:
        """Write ``state`` (a ``TrainState`` or a host ``Snapshot``) as
        step ``step``, then remove all but the newest ``keep`` files."""
        path = self.path(step)
        if path.exists():
            return
        save_train_state(path, state, **kw)
        for old in self.steps()[:-self.keep]:
            self.path(old).unlink(missing_ok=True)


def snapshot_bytes(state) -> int:
    """The bytes of a device snapshot of ``state`` (a ``TrainState``, a
    dict of its tensors, or anything iterable of objects with
    ``nbytes``)."""
    if isinstance(state, TrainState):
        state = _state_tensors(state)
    if isinstance(state, dict):
        return sum(t.numel() * t.element_size() for t in state.values())
    return sum(int(t.nbytes) for t in state)


def background_ckpt_fits(state, *, device=None, tensors=None) -> bool:
    """Whether the card has room for the background saver's snapshot, one
    more copy of the state while training goes on: its bytes within 15% of
    the card's total memory (``torch.cuda.mem_get_info``), or within 2 GiB
    where the total is not known (the CPU).  ``DPHUBERT_BG_CKPT=1/0``
    overrides the decision; ``DPHUBERT_SYNC_CKPT=1`` (the TPU package's
    switch) is ``DPHUBERT_BG_CKPT=0``.  ``tensors``: the one-card tensors
    of a state split on a mesh, which the snapshot holds."""
    force = os.environ.get("DPHUBERT_BG_CKPT")
    if os.environ.get("DPHUBERT_SYNC_CKPT") == "1":
        force = "0"
    if force is not None:
        return force != "0"
    if device is None and isinstance(state, TrainState):
        device = state.generator.device
    total = None
    if device is not None and torch.device(device).type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
    budget = int(total * BG_CKPT_SHARE) if total else BG_CKPT_CAP_BYTES
    return snapshot_bytes(state if tensors is None else tensors) <= budget


class BackgroundSaver:
    """Takes the checkpoint's copy to the host and its write off the step
    path (the TPU package's ``BackgroundSaver``).

    ``submit(state, **kw)`` takes ``device_snapshot(state)`` on the compute
    stream, records an event and returns; a writer thread copies the
    snapshot to pinned host memory on a side stream behind that event and
    calls ``save_fn(host_snapshot, **kw)``.  One save is in flight at a
    time: a ``submit`` while the previous one is still writing waits for it,
    which also bounds the extra card memory to one copy of the state.

    The pinned buffers are kept from save to save (``reserve`` makes them
    before training starts), so the host snapshot handed to ``save_fn`` is
    valid only until it returns.  A failure in the writer must not end a
    long run: that step's checkpoint is lost (the next supersedes it), a
    warning is logged, and every later ``submit`` saves synchronously from
    the live state.  ``close()`` returns a failure of the last save instead
    of raising, so that the trainer can rewrite the final checkpoint
    synchronously."""

    def __init__(self, save_fn: Callable):
        self._save_fn = save_fn
        self._pinned: dict = {}
        self._q: queue.Queue = queue.Queue()
        self._slot = threading.Semaphore(1)
        self._exc: Optional[BaseException] = None
        self._degraded = False
        self._stream = None
        self._thread = threading.Thread(target=self._worker, daemon=True, name="ckpt-saver")
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            snap, ready, kwargs = item
            try:
                host = snapshot_to_host(snap, self._stream, ready, self._pinned)
                del snap, item
                self._save_fn(host, **kwargs)
            except BaseException as e:  # noqa: BLE001 - handled on the main thread
                self._exc = e
            finally:
                self._slot.release()

    def _take_exc(self) -> Optional[BaseException]:
        exc, self._exc = self._exc, None
        return exc

    def _degrade(self, exc: BaseException, when: str, state, tensors, kwargs) -> None:
        logging.getLogger("dphubert_torch").warning(
            "background checkpoint save failed %s (%s: %s); that step's checkpoint is "
            "lost; saving synchronously for the rest of the run", when, type(exc).__name__, exc)
        self._degraded = True
        self._save_fn(host_snapshot(state, tensors), **kwargs)

    def reserve(self, state: TrainState, tensors=None) -> None:
        """Pin the host buffers a snapshot of ``state`` (of ``tensors``,
        where given) goes to, now rather than at the first ``submit`` (on
        the card only)."""
        if state.generator.device.type != "cuda":
            return
        numel: Dict[torch.dtype, int] = {}
        for t in (_state_tensors(state) if tensors is None else tensors).values():
            numel[t.dtype] = numel.get(t.dtype, 0) + t.numel()
        for dtype, n in numel.items():
            _pinned(self._pinned, dtype, n)

    def submit(self, state: TrainState, tensors=None, **kwargs) -> None:
        """Snapshot ``state`` (its ``tensors``, where given: the one-card
        tensors of a state split on a mesh) and hand it to the writer."""
        if self._degraded:
            self._save_fn(host_snapshot(state, tensors), **kwargs)
            return
        self._slot.acquire()  # wait out a save in flight, if any
        prev = self._take_exc()
        if prev is not None:
            self._slot.release()
            self._degrade(prev, "in the writer", state, tensors, kwargs)
            return
        try:
            snap = device_snapshot(state, tensors)
            ready = None
            if snap.generator_device == "cuda":
                device = state.generator.device
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
        except BaseException as e:  # noqa: BLE001 - degrade, do not end the run
            self._slot.release()
            self._degrade(e, "taking the device snapshot", state, tensors, kwargs)
            return
        self._q.put((snap, ready, kwargs))

    def in_flight(self) -> bool:
        """Whether a background save is still copying or writing."""
        if self._slot.acquire(blocking=False):
            self._slot.release()
            return False
        return True

    def wait(self) -> None:
        """Return once no save is in flight."""
        self._slot.acquire()
        self._slot.release()

    def close(self) -> Optional[BaseException]:
        """Wait for the save in flight and stop the writer; returns the
        failure of the last background save, or None."""
        self._slot.acquire()
        self._q.put(None)
        self._thread.join()
        self._slot.release()
        return self._take_exc()
