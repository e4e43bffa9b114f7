"""Row sampling for sample-based fits (PCA, GMM).

A numpy-only copy of ``keystone_tpu/nodes/stats/samplers.py::sample_rows``:
the same ``(n, num_samples, seed)`` picks the same rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def sample_row_indices(n: int, num_samples: int, seed: int = 0) -> Optional[np.ndarray]:
    """Sorted indices of the rows ``sample_rows`` keeps out of ``n``, or
    None when it keeps them all."""
    if num_samples >= n:
        return None
    return np.sort(np.random.default_rng(seed).choice(n, size=num_samples, replace=False))


def sample_rows(X, num_samples: int, seed: int = 0):
    idx = sample_row_indices(X.shape[0], num_samples, seed)
    return X if idx is None else X[idx]
