"""The comparisons that decide ``correct``."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want| (inf where got is not finite)."""
    if not np.isfinite(got):
        return float("inf")
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's (not
    the norm of their difference), against the larger of that leaf's
    reference norm and the median leaf's (inf where got is not finite)."""
    med = float(np.median(list(want.values())))
    return {n: float("inf") if not np.isfinite(got[n]) else abs(got[n] - w) / max(w, med, 1e-30)
            for n, w in want.items()}


def leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> Tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``); (gap, leaf)."""
    gaps = leaf_gaps(got, want)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def feature_gap(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| over a clip's valid frames (inf where the
    shapes differ or got is not finite)."""
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.linalg.norm(got.astype(np.float64) - want)
                 / max(np.linalg.norm(want.astype(np.float64)), 1e-30))
