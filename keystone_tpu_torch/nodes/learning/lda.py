"""Linear discriminant analysis (counterpart of
keystone_tpu/nodes/learning/lda.py).

Within-class and between-class scatter, one class at a time as in the
reference; ``Sw + εI`` whitened by its ``eigh``; the top ``dims``
eigenvectors of the whitened ``Sb``, best first. Returns
``PCATransformer(inv_sqrt @ top, mean)`` on the data's device.

Eigenvector signs are the solver's choice (LAPACK, cuSOLVER and XLA pick
differently), and ``Sb`` has rank at most C − 1, so directions past that
rank are arbitrary.
"""

from __future__ import annotations

import numpy as np
import torch

from keystone_tpu_torch.config import as_input
from keystone_tpu_torch.nodes.learning.pca import PCATransformer
from keystone_tpu_torch.workflow import LabelEstimator


class LinearDiscriminantAnalysis(LabelEstimator):
    """Fits on the device of a tensor it is given; host arrays go to
    ``device`` (``cuda`` unless named)."""

    def __init__(self, dims: int, eps: float = 1e-6, device=None):
        self.dims = dims
        self.eps = eps
        self.device = device

    def fit(self, data, labels) -> PCATransformer:
        X = as_input(data, self.device)
        if isinstance(labels, torch.Tensor):
            y = labels.to(X.device).to(torch.int32).ravel()
        else:
            y = torch.as_tensor(np.asarray(labels).astype(np.int32).ravel(), device=X.device)
        mean = X.mean(dim=0)
        d = X.shape[1]
        Sw = torch.zeros((d, d), dtype=X.dtype, device=X.device)
        Sb = torch.zeros((d, d), dtype=X.dtype, device=X.device)
        for c in torch.unique(y):
            mask = (y == c)[:, None].to(X.dtype)
            nc = mask.sum()
            mu_c = (X * mask).sum(dim=0) / torch.clamp_min(nc, 1.0)
            Xc = (X - mu_c) * mask
            Sw = Sw + Xc.T @ Xc
            diff = (mu_c - mean)[:, None]
            Sb = Sb + nc * (diff @ diff.T)
        # Sw⁻¹ Sb through symmetric whitening, for stability.
        evals_w, evecs_w = torch.linalg.eigh(Sw + self.eps * torch.eye(d, dtype=X.dtype, device=X.device))
        inv_sqrt = (evecs_w / torch.sqrt(evals_w)) @ evecs_w.T
        M = inv_sqrt @ Sb @ inv_sqrt
        _evals, evecs = torch.linalg.eigh(M)
        # eigh sorts ascending: the top ``dims``, best first.
        top = evecs.flip(1)[:, : self.dims]
        return PCATransformer(inv_sqrt @ top, mean, device=X.device)
