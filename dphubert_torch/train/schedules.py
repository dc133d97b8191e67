"""Learning-rate schedules (the TPU package's ``train/schedules.py``).

Both schedules return a multiplicative *factor* applied to every parameter
group's base learning rate, matching torch ``_LRScheduler`` semantics where
``_step_count`` is 1 at the first optimizer update: for an update count
``count`` (0 at the first update) the factor uses ``t = count + 1``.  The
arithmetic is float32, as in the TPU package; the count is a host integer.
"""

from __future__ import annotations

import math

import numpy as np


def linear_decay_factor(count: int, warmup_updates: int, max_updates: int) -> float:
    """Linear warmup to the base rate, then linear decay to 0 at
    ``max_updates``."""
    t = np.float32(count + 1)
    if t >= max_updates:
        return 0.0
    if t <= warmup_updates:
        return float(t / np.float32(max(warmup_updates, 1)))
    return float((np.float32(max_updates) - t) / np.float32(max(max_updates - warmup_updates, 1)))


def tri_stage_factor(
    count: int,
    warmup_updates: int,
    hold_updates: int,
    decay_updates: int,
    init_lr_scale: float = 0.01,
    final_lr_scale: float = 0.05,
) -> float:
    """Warmup / hold / exponential decay."""
    t = np.float32(count + 1)
    if t <= warmup_updates:
        return float(np.float32(init_lr_scale + t / np.float32(max(warmup_updates, 1))
                                * (1 - init_lr_scale)))
    if t <= warmup_updates + hold_updates:
        return 1.0
    if t <= warmup_updates + hold_updates + decay_updates:
        return float(np.float32(np.exp(
            np.float32(math.log(final_lr_scale)) * (t - warmup_updates - hold_updates)
            / np.float32(max(decay_updates, 1))
        )))
    return float(np.float32(final_lr_scale))
