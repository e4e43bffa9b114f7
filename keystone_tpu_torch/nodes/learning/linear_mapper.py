"""A dense linear model fitted by ridge least squares.

Counterpart of ``keystone_tpu/nodes/learning/linear_mapper.py`` (:28-108):

- ``LinearMapper``: ``X @ W + b``;
- ``LinearMapEstimator(lam, method)``: the intercept by centering. The
  column means x̄ and ȳ are taken first (column sums over n); W solves
  the centered ridge problem, by the normal equations (``normal``; the
  centered A rounded once into ``config.solver_storage_dtype()``) or by
  the QR of [A | B] (``tsqr``; A at full float32 width), and
  ``b = ȳ − x̄ᵀW``.

``partial_fit`` and ``solve_online`` belong to the reference's online
trainer (``workflow/online.py``), which is not ported: they raise.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.linalg.normal_equations import solve_least_squares_normal
from keystone_tpu_torch.linalg.row_matrix import solver_matmul, storage_dtype
from keystone_tpu_torch.linalg.tsqr import solve_least_squares_tsqr
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import LabelEstimator, Transformer

METHODS = ("normal", "tsqr")


class LinearMapper(Transformer):
    def __init__(self, W, b=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("W", torch.as_tensor(W, dtype=default_dtype, device=device))
        self.register_buffer("b", None if b is None else torch.as_tensor(b, dtype=default_dtype, device=device))

    def apply_batch(self, X):
        out = X @ self.W
        return out if self.b is None else out + self.b


class LinearMapEstimator(LabelEstimator):
    """Fits on the device of a tensor it is given; host arrays go to
    ``device`` (``cuda`` unless named)."""

    def __init__(self, lam: float = 0.0, method: str = "normal", device=None):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        self.lam = lam
        self.method = method
        self.device = device

    def partial_fit(self, data, labels, state=None, decay=None, window=None, chunk_rows=None):
        raise NotImplementedError(
            "partial_fit comes with the online trainer (workflow/online.py), ROADMAP Queue 1 item 3"
        )

    def solve_online(self, state):
        raise NotImplementedError(
            "solve_online comes with the online trainer (workflow/online.py), ROADMAP Queue 1 item 3"
        )

    def fit(self, data, labels) -> LinearMapper:
        X = as_input(data, self.device)
        Y = as_input(labels, X.device).to(X.device)
        x_mean = X.sum(dim=0) / X.shape[0]
        y_mean = Y.sum(dim=0) / Y.shape[0]
        if self.method == "tsqr":
            # QR is sensitive to the storage dtype: it keeps full width.
            W = solve_least_squares_tsqr(X - x_mean, Y - y_mean, self.lam)
        else:
            # Centered in float32, rounded once into the storage dtype.
            A = torch.sub(X, x_mean, out=torch.empty(X.shape, dtype=storage_dtype(), device=X.device))
            W = solve_least_squares_normal(A, Y - y_mean, self.lam)
        b = y_mean - solver_matmul(x_mean[None, :], W)[0]
        mark(f"linear solve ({self.method})")
        return LinearMapper(W, b, device=W.device)
