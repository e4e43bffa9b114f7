"""Tolerant numeric comparison (counterpart of
keystone_tpu/utils/stats.py::about_eq, numpy only, copied as it is)."""

from __future__ import annotations

import numpy as np


def about_eq(a, b, tol: float = 1e-6) -> bool:
    """True if every element of |a - b| is within tol (absolute).

    Mirrors `Stats.aboutEq(a, b, tol)`. Accepts scalars, arrays, or nested
    sequences; uses max-abs difference like the reference.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    return bool(np.max(np.abs(a - b), initial=0.0) <= tol)
