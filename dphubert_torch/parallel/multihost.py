"""Process-group start-up (the TPU package's ``parallel/multihost.py``).

The reference scales with one DDP process per GPU and rank-strided batch
lists (``audio_dataset.py:196-211``).  The port runs one process per card
as well: ``python -m torch.distributed.run --nproc_per_node N`` (torchrun)
starts them and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR`` / ``MASTER_PORT``; every process decodes only the rows of
each global batch that its data rank owns (``process_row_slice``,
``DistillDataLoader(shard=...)``); the batch order is the same everywhere
(the batcher is seeded by (seed, epoch)).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(device="cuda", *, backend: Optional[str] = None, store=None,
               rank: Optional[int] = None, world_size: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device.

    From torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``), or from an explicit ``store`` with
    ``rank`` and ``world_size`` (the tests rendezvous through a
    ``FileStore``).  The backend is ``nccl`` for the card and ``gloo`` for
    the CPU unless ``backend`` names one (gloo on the card: two ranks on one
    card, which NCCL refuses).  The rank's device is ``cuda:LOCAL_RANK`` on
    the card (made current) and the CPU otherwise.

    A no-op for one process (no store, ``WORLD_SIZE`` unset or 1), and when
    a group is already up: then ``device`` is returned as given."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dist.is_initialized():
        return _rank_device(device)
    if store is None and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if store is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return _rank_device(device)


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", device.index or 0))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def is_initialized() -> bool:
    return dist.is_initialized()


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 logs, validates and writes."""
    return rank() == 0


def process_row_slice(data_rank: int, n_data: int, global_batch: int) -> slice:
    """The contiguous block of a global batch's rows that data rank
    ``data_rank`` of ``n_data`` owns (the batcher makes every global batch
    a multiple of ``n_data``)."""
    if global_batch % n_data:
        raise ValueError(f"a global batch of {global_batch} rows does not split over "
                         f"{n_data} data ranks")
    local = global_batch // n_data
    return slice(data_rank * local, (data_rank + 1) * local)
