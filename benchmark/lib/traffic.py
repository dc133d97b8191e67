"""What every traffic mix shares: the length table of its parameter file
(``assumed.length_table``) and the clip lengths drawn from it.  Each kind of
mix (the file's ``kind``) has its generator in ``benchmark/drivers/<kind>.py``,
which makes, from the run's seed, what the window feeds; every seed gets the
same sizes, and the seed sets their order and the audio's samples."""

from __future__ import annotations

from typing import Tuple

import numpy as np

SR = 16000
FRAME = 320  # samples per output frame of the CNN


def table(mix: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bin lower edges, upper edges, share of utterances) in seconds."""
    rows = mix["assumed"]["length_table"]["bins"]
    lo = np.array([r[0] for r in rows], float)
    hi = np.array([r[1] for r in rows], float)
    w = np.array([r[2] for r in rows], float)
    return lo, hi, w / w.sum()


def quantiles(mix: dict, n: int, lo_s: float, hi_s: float) -> np.ndarray:
    """n clip lengths in seconds: the table's distribution (uniform within
    a bin) cut to [lo_s, hi_s], at the probabilities (i + 0.5) / n."""
    lo, hi, w = table(mix)
    a, b = np.maximum(lo, lo_s), np.minimum(hi, hi_s)
    mass = w * np.clip(b - a, 0, None) / (hi - lo)
    cdf = np.concatenate([[0.0], np.cumsum(mass)]) / mass.sum()
    out = []
    for p in (np.arange(n) + 0.5) / n:
        i = min(int(np.searchsorted(cdf, p, side="right")) - 1, len(mass) - 1)
        while mass[i] == 0:
            i += 1
        frac = (p - cdf[i]) / (cdf[i + 1] - cdf[i])
        out.append(a[i] + frac * (b[i] - a[i]))
    return np.array(out)
