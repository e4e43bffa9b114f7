"""Controlled label noise for the synthetic datasets.

A numpy-only copy of ``keystone_tpu/loaders/synthetic.py``
(``label_noise_rate`` :24, ``with_label_noise`` :31): the fraction
``KEYSTONE_SYNTH_LABEL_NOISE`` (unset or unparsable: off) of labels moves
to another class, drawn from the generator's own per-split ``rng``, so the
same seed gives the same noisy labels as the reference.
"""

from __future__ import annotations

import os

import numpy as np


def label_noise_rate() -> float:
    try:
        return float(os.environ.get("KEYSTONE_SYNTH_LABEL_NOISE", "") or 0.0)
    except ValueError:
        return 0.0


def with_label_noise(y: np.ndarray, num_classes: int, rng) -> np.ndarray:
    """Integer labels move to a uniformly drawn other class; a 2-d
    multi-label indicator matrix flips each entry with the same
    probability."""
    p = label_noise_rate()
    if p <= 0.0:
        return y
    y = np.array(y, copy=True)
    if y.ndim == 2:
        flip = rng.uniform(size=y.shape) < p
        y[flip] = 1 - y[flip]
        return y
    flip = rng.uniform(size=y.shape[0]) < p
    shift = rng.integers(1, max(num_classes, 2), size=y.shape[0])
    y[flip] = (y[flip] + shift[flip]) % max(num_classes, 2)
    return y
