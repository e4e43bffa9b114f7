"""Diagonal-covariance Gaussian mixture fitted by EM.

Counterpart of ``keystone_tpu/nodes/learning/gmm.py``
(``GaussianMixtureModel``, ``_fit_gmm``, ``GaussianMixtureModelEstimator``),
with ``_fit_gmm`` split in two so that each half can be held against the
reference on its own:

- ``gmm_from_centers``: hard assignment to k-means centers, and each
  cluster's weight, mean and variance (variances floored at ``min_var``);
- ``em_sweeps``: EM sweeps, responsibilities from the expanded gemm-shaped
  quadratic form and a softmax, moments re-estimated by two gemms
  (``torch.matmul``, float32; component masses floored at 1e-6).

The estimator runs k-means++ seeding and 5 Lloyd sweeps first, as the
reference does. ``mark`` closes the "k-means" and "EM" stages for an
active ``StageTimer``.
"""

from __future__ import annotations

import math

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.nodes.learning.kernels import pairwise_sq_dists
from keystone_tpu_torch.nodes.learning.kmeans import kmeans_plus_plus_seeds, lloyd
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import Estimator, Transformer

MASS_FLOOR = 1e-6


def log_likelihoods(X, weights, means, variances):
    """(n, k) log p(x | component j) + log w_j."""
    inv = 1.0 / variances
    quad = (X * X) @ inv.T - 2.0 * X @ (means * inv).T + (means * means * inv).sum(dim=1)
    d = X.shape[1]
    log_norm = -0.5 * (d * math.log(2 * math.pi) + torch.log(variances).sum(dim=1))
    return torch.log(weights) + log_norm - 0.5 * quad


class GaussianMixtureModel(Transformer):
    """Fitted GMM; as a stage it emits responsibilities."""

    def __init__(self, weights, means, variances, device=None):
        super().__init__()
        device = resolve_device(device)
        for name, value in (("weights", weights), ("means", means), ("variances", variances)):
            self.register_buffer(name, torch.as_tensor(value, dtype=default_dtype, device=device))

    def log_likelihoods(self, X):
        return log_likelihoods(X, self.weights, self.means, self.variances)

    def apply_batch(self, X):
        return torch.softmax(self.log_likelihoods(X), dim=-1)

    def predict(self, X):
        return self.log_likelihoods(X).argmax(dim=-1)


def gmm_from_centers(X: torch.Tensor, centers: torch.Tensor, min_var: float):
    """(weights, means, variances) of the hard clusters around ``centers``."""
    n, k = X.shape[0], centers.shape[0]
    assign = pairwise_sq_dists(X, centers).argmin(dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)
    counts = torch.clamp_min(onehot.sum(dim=0), 1.0)
    means = (onehot.T @ X) / counts[:, None]
    ex2 = (onehot.T @ (X * X)) / counts[:, None]
    return counts / n, means, torch.clamp_min(ex2 - means**2, min_var)


def em_sweeps(X: torch.Tensor, weights, means, variances, iters: int, min_var: float):
    n = X.shape[0]
    for _ in range(iters):
        r = torch.softmax(log_likelihoods(X, weights, means, variances), dim=-1)  # (n, k)
        nk = torch.clamp_min(r.sum(dim=0), MASS_FLOOR)
        means = (r.T @ X) / nk[:, None]
        ex2 = (r.T @ (X * X)) / nk[:, None]
        variances = torch.clamp_min(ex2 - means**2, min_var)
        weights = nk / n
    return weights, means, variances


class GaussianMixtureModelEstimator(Estimator):
    """``fit`` runs on the device of a tensor it is given; a host array goes
    to ``device`` (``cuda`` unless named)."""

    def __init__(self, k: int, max_iters: int = 50, min_var: float = 1e-4, seed: int = 0,
                 device=None):
        self.k = k
        self.max_iters = max_iters
        self.min_var = min_var
        self.seed = seed
        self.device = device

    def fit(self, data) -> GaussianMixtureModel:
        X = as_input(data, self.device)
        g = torch.Generator().manual_seed(self.seed)
        centers = lloyd(X, kmeans_plus_plus_seeds(X, self.k, g), 5)
        init = gmm_from_centers(X, centers, self.min_var)
        mark("k-means")
        fitted = em_sweeps(X, *init, self.max_iters, self.min_var)
        mark("EM")
        return GaussianMixtureModel(*fitted, device=X.device)
