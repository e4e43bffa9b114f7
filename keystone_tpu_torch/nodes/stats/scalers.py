"""Mean and standard-deviation scaling (counterpart of
``keystone_tpu/nodes/stats/scalers.py``): ``StandardScaler.fit`` takes the
column means and, with ``normalize_std_dev``, the column standard
deviations (``ddof=1``) floored at ``eps``; the model subtracts the one and
divides by the other. Fit and apply run on the device of the data: a
tensor stays where it is, a host array goes to ``device`` (``cuda`` unless
named)."""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.workflow import Estimator, Transformer


class StandardScalerModel(Transformer):
    def __init__(self, mean, std=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("mean", torch.as_tensor(mean, dtype=default_dtype, device=device))
        self.register_buffer(
            "std", None if std is None else torch.as_tensor(std, dtype=default_dtype, device=device)
        )

    def apply_batch(self, X):
        out = X - self.mean
        if self.std is not None:
            out = out / self.std
        return out


class StandardScaler(Estimator):
    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-8, device=None):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps
        self.device = device

    def fit(self, data) -> StandardScalerModel:
        X = as_input(data, self.device)
        mean = X.mean(dim=0)
        std = None
        if self.normalize_std_dev:
            std = torch.clamp_min(X.std(dim=0, correction=1), self.eps)
        return StandardScalerModel(mean, std, device=X.device)
