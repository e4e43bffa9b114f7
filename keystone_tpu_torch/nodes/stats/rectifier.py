"""Linear rectifier (counterpart of
``keystone_tpu/nodes/stats/rectifier.py::LinearRectifier``, :13):
``max(X − alpha, max_val)``."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow import Transformer


class LinearRectifier(Transformer):
    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        super().__init__()
        self.max_val = max_val
        self.alpha = alpha

    def signature(self):
        return self.stable_signature(self.max_val, self.alpha)

    def apply_batch(self, X):
        return torch.clamp_min(X - self.alpha, self.max_val)
