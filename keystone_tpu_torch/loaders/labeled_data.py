"""(data, labels) pairs, and the size of an image loader's decode pool.

Counterpart of ``keystone_tpu/loaders/labeled_data.py``: ``LabeledData``
and a copy of ``decode_pool_workers`` (``:23-33``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


class LabeledData(NamedTuple):
    data: np.ndarray
    labels: np.ndarray


def decode_pool_workers(requested: Optional[int]) -> int:
    """Decode threads: ``requested``, or 16, capped at the host's cores.
    JPEG decode is bound by the CPU, so a thread beyond the core count only
    adds contention."""
    cores = os.cpu_count() or 1
    if requested is None:
        return min(16, cores)
    return max(1, min(requested, cores))
