"""Dense least squares in one solve (counterpart of
keystone_tpu/nodes/learning/local_least_squares.py): the low-(n, d) corner
of ``LeastSquaresEstimator``'s cost model.

The ridge problem is centred, ``(XcᵀXc + λI) W = XcᵀYc`` solved by
``torch.linalg.solve`` on the data's device, and ``b = ȳ − x̄ᵀW``.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapper
from keystone_tpu_torch.workflow import LabelEstimator


def _solve(X: torch.Tensor, Y: torch.Tensor, lam: float):
    x_mean = X.mean(dim=0)
    y_mean = Y.mean(dim=0)
    Xc = X - x_mean
    Yc = Y - y_mean
    d = X.shape[1]
    G = Xc.T @ Xc + lam * torch.eye(d, dtype=X.dtype, device=X.device)
    W = torch.linalg.solve(G, Xc.T @ Yc)
    return W, y_mean - x_mean @ W


class LocalLeastSquaresEstimator(LabelEstimator):
    """Fits on the device of a tensor it is given; host arrays go to
    ``device`` (``cuda`` unless named)."""

    def __init__(self, lam: float = 0.0, device=None):
        self.lam = lam
        self.device = device

    def fit(self, data, labels) -> LinearMapper:
        X = as_input(data, self.device)
        Y = as_input(labels, X.device).to(X.device)
        W, b = _solve(X, Y, self.lam)
        return LinearMapper(W, b, device=X.device)
