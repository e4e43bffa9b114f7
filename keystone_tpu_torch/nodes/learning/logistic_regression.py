"""Multinomial logistic regression fitted by L-BFGS (counterpart of
``keystone_tpu/nodes/learning/logistic_regression.py``).

The fit minimises the mean softmax cross-entropy plus ``0.5·reg·‖W‖²``
(b is not penalised) from zero weights by exactly ``max_iters`` L-BFGS
steps (``linalg/lbfgs.py``, optax's defaults; the reference runs
``optax.lbfgs()`` in a ``lax.scan`` with no early stop). Its gradient is
written out, not taken by autograd: with P the row-wise softmax of
``X W + b`` and Y the one-hot labels,

    ∇W = Xᵀ (P − Y) / n + reg·W,    ∇b = Σ_rows (P − Y) / n.

Dense features lie on the device of the data (a host array goes to
``device``, ``cuda`` unless named). A ``SparseBatch`` stays sparse: X and
a copy of Xᵀ, each a CSR tensor made once on ``device``, serve every
product (cuSPARSE on the card), and no (n, d) dense array is made, as the
reference keeps its BCOO. The model takes dense rows (host or tensor) or a
``SparseBatch`` and gives class scores (logits).
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.linalg.lbfgs import LbfgsResult, minimize
from keystone_tpu_torch.nodes.learning.naive_bayes import as_rows, host_labels
from keystone_tpu_torch.utils.sparse import SparseBatch
from keystone_tpu_torch.workflow import LabelEstimator, Transformer


class LogisticRegressionModel(Transformer):
    def __init__(self, W, b, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("W", torch.as_tensor(W, dtype=default_dtype, device=device))
        self.register_buffer("b", torch.as_tensor(b, dtype=default_dtype, device=device))

    def apply_batch(self, X):
        device = self.W.device
        if isinstance(X, SparseBatch):
            return X.to_torch(device) @ self.W + self.b
        return torch.addmm(self.b, as_rows(X, device), self.W)


def softmax_objective(X, XT, y: torch.Tensor, num_classes: int, reg: float):
    """``value_and_grad(x)`` of the objective at the flat parameters
    x = [W (d·k, row-major), b (k)]: X (n, d) and XT its transpose, dense
    or CSR; y the int64 labels on X's device."""
    n, d = X.shape
    k = num_classes
    rows = torch.arange(n, device=y.device)

    def value_and_grad(x):
        W, b = x[: d * k].view(d, k), x[d * k :]
        logits = X @ W + b
        logp = torch.log_softmax(logits, dim=1)
        value = -logp[rows, y].mean() + 0.5 * reg * torch.dot(x[: d * k], x[: d * k])
        P = logp.exp_()
        P[rows, y] -= 1.0
        P /= n
        grad = torch.cat([(XT @ P + reg * W).reshape(-1), P.sum(dim=0)])
        return value, grad

    return value_and_grad


class LogisticRegressionEstimator(LabelEstimator):
    def __init__(self, num_classes: int, reg: float = 1e-4, max_iters: int = 100, device=None):
        self.num_classes = num_classes
        self.reg = reg
        self.max_iters = max_iters
        self.device = device
        self.result: LbfgsResult | None = None  # the last fit's, for its values per step

    def fit(self, data, labels) -> LogisticRegressionModel:
        if isinstance(data, SparseBatch):
            device = resolve_device(self.device)
            X, XT = data.to_torch(device), data.to_torch(device, transpose=True)
        else:
            X = as_input(data, self.device)
            device, XT = X.device, X.T
        y = torch.as_tensor(host_labels(labels), device=device)
        d, k = X.shape[1], self.num_classes
        fn = softmax_objective(X, XT, y, k, self.reg)
        self.result = minimize(fn, torch.zeros(d * k + k, dtype=default_dtype, device=device),
                               self.max_iters)
        x = self.result.x
        return LogisticRegressionModel(x[: d * k].view(d, k), x[d * k :], device=device)
