"""ZCA whitening, RandomPatchCifar's preprocessing (counterpart of
``keystone_tpu/nodes/learning/zca.py``, :16-39).

``ZCAWhitenerEstimator(eps).fit(X)`` takes the mean μ and the covariance
C = (X − μ)ᵀ(X − μ)/n, decomposes C = V diag(λ) Vᵀ (``torch.linalg.eigh``)
and gives the whitener ``M = V diag(1/√(max(λ, 0) + eps)) Vᵀ``; the node
maps ``x → (x − μ)M``. M does not depend on the eigenvectors' signs or on
the basis chosen within a repeated eigenvalue, so it is what a comparison
holds.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.workflow import Estimator, Transformer


class ZCAWhitener(Transformer):
    def __init__(self, whitener, mean, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("whitener", torch.as_tensor(whitener, dtype=default_dtype, device=device))
        self.register_buffer("mean", torch.as_tensor(mean, dtype=default_dtype, device=device))

    def apply_batch(self, X):
        return (X - self.mean) @ self.whitener


class ZCAWhitenerEstimator(Estimator):
    """Fits on the device of a tensor it is given; a host array goes to
    ``device`` (``cuda`` unless named)."""

    def __init__(self, eps: float = 0.1, device=None):
        self.eps = eps
        self.device = device

    def fit(self, data) -> ZCAWhitener:
        X = as_input(data, self.device)
        mean = X.mean(dim=0)
        Xc = X - mean
        cov = (Xc.T @ Xc) / X.shape[0]
        evals, evecs = torch.linalg.eigh(cov)
        scale = 1.0 / torch.sqrt(torch.clamp_min(evals, 0.0) + self.eps)
        return ZCAWhitener((evecs * scale) @ evecs.T, mean, device=X.device)
