"""K-means++ clustering.

Counterpart of ``keystone_tpu/nodes/learning/kmeans.py`` (``_fit_kmeans``,
``KMeansPlusPlusEstimator``, ``KMeansModel``), split in two so that each
half can be held against the reference on its own:

- ``kmeans_plus_plus_seeds``: k-means++ seeding, each new seed drawn with
  probability proportional to its squared distance from the nearest seed;
- ``lloyd``: Lloyd sweeps from given centers (pairwise distances, argmin,
  one-hot gemm recentering); an empty cluster keeps its old center.

The random numbers come from a CPU ``torch.Generator``: the first seed's
index and one uniform per later seed, drawn up front. Each later seed is
found on the data's device by searching the cumulative distances for its
uniform, so the card and the CPU draw the same numbers (the reference's
``jax.random`` stream cannot be replayed; compare distributions).
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.nodes.learning.kernels import pairwise_sq_dists
from keystone_tpu_torch.workflow import Estimator, Transformer


def kmeans_plus_plus_seeds(X: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """(k, d) seeds, each a row of X."""
    n = X.shape[0]
    first = int(torch.randint(n, (), generator=generator))
    uniforms = torch.rand(k - 1, generator=generator, dtype=torch.float64).to(X.device)
    centers = X.new_empty((k, X.shape[1]))
    centers[0] = X[first]
    d2 = ((X - X[first]) ** 2).sum(dim=1)
    for i in range(1, k):
        cum = torch.cumsum(d2.to(torch.float64), dim=0)
        # right=True lands past every row of zero mass (a seed already).
        idx = torch.searchsorted(cum, uniforms[i - 1 : i] * cum[-1], right=True)
        seed = X[idx.clamp_max(n - 1)]
        centers[i] = seed[0]
        d2 = torch.minimum(d2, ((X - seed) ** 2).sum(dim=1))
    return centers


def lloyd(X: torch.Tensor, centers: torch.Tensor, iters: int) -> torch.Tensor:
    k = centers.shape[0]
    for _ in range(iters):
        assign = pairwise_sq_dists(X, centers).argmin(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # (n, k)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ X) / torch.clamp_min(counts, 1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    return centers


class KMeansModel(Transformer):
    def __init__(self, centers, device=None):
        super().__init__()
        self.register_buffer(
            "centers",
            torch.as_tensor(centers, dtype=default_dtype, device=resolve_device(device)),
        )

    def predict(self, X):
        return pairwise_sq_dists(X, self.centers).argmin(dim=1)

    def apply_batch(self, X):
        """One-hot encoding of the nearest center."""
        return torch.nn.functional.one_hot(self.predict(X), self.centers.shape[0]).to(
            default_dtype
        )


class KMeansPlusPlusEstimator(Estimator):
    """``fit`` runs on the device of a tensor it is given; a host array goes
    to ``device`` (``cuda`` unless named)."""

    def __init__(self, k: int, max_iters: int = 20, seed: int = 0, device=None):
        self.k = k
        self.max_iters = max_iters
        self.seed = seed
        self.device = device

    def fit(self, data) -> KMeansModel:
        X = as_input(data, self.device)
        g = torch.Generator().manual_seed(self.seed)
        centers = lloyd(X, kmeans_plus_plus_seeds(X, self.k, g), self.max_iters)
        return KMeansModel(centers, device=X.device)
