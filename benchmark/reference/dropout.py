"""The attention-dropout mask: a frozen copy of the counter hash that the
recipe's attention uses (a murmur3 finalizer of the 32-bit seed, the batch
row, the head, the query row and the key column, kept where the hash is at
most the keep threshold).  Written out in int64 arithmetic with a mask after
every product and sum."""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF
_SEED_B, _SEED_H = 0x9E3779B1, 0x85EBCA77
_ROW, _COL = 0x27D4EB2F, 0x165667B1
_MIX1, _MIX2 = 0x7FEB352D, 0x846CA68B


def threshold(keep: float) -> int:
    """uint32(min(keep, 1) * 4294967295.0), truncated from a double."""
    return int(np.uint32(min(keep, 1.0) * 4294967295.0))


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), c split in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_mask(seed: int, keep: float, B: int, H: int, L: int, device) -> torch.Tensor:
    """(B, H, L, L) bool: True where the unit is kept."""
    b = torch.arange(B, dtype=torch.int64, device=device).view(B, 1, 1, 1)
    h = torch.arange(H, dtype=torch.int64, device=device).view(1, H, 1, 1)
    s = ((int(seed) & _U32) + _mul(b, _SEED_B) + _mul(h, _SEED_H)) & _U32
    r = torch.arange(L, dtype=torch.int64, device=device)
    x = _mul(r, _ROW)[:, None] ^ _mul(r, _COL)[None, :] ^ s
    x = x ^ (x >> 16)
    x = _mul(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul(x, _MIX2)
    x = x ^ (x >> 16)
    return x <= threshold(keep)
