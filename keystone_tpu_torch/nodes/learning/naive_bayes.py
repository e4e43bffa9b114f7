"""Multinomial naive Bayes (counterpart of
``keystone_tpu/nodes/learning/naive_bayes.py``): Laplace smoothing, the log
prior and the log likelihood; the model gives log-posterior scores, so
``MaxClassifier`` composes after it.

- Dense features: the fit is ``onehotᵀ @ X`` on the device of the data (a
  host array goes to ``device``, ``cuda`` unless named).
- A ``SparseBatch``: the fit is the reference's host reduction,
  ``grouped_column_sums`` (one bincount over the CSR entries); its (k, d)
  counts then go to ``device``.
- The model on a ``SparseBatch`` multiplies the CSR batch on the device
  (``SparseBatch.to_torch``, cuSPARSE on the card) where the reference
  accumulates host block products: the same scores, in another summation
  order. Dense host rows go to the model's device first.

Labels outside [0, k) raise.
"""

from __future__ import annotations

import numpy as np
import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.utils.sparse import SparseBatch
from keystone_tpu_torch.workflow import LabelEstimator, Transformer


def host_labels(labels) -> np.ndarray:
    """Integer labels (a host array, a list or a tensor) as int64 numpy."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    return np.asarray(labels).astype(np.int64).ravel()


def as_rows(X, device) -> torch.Tensor:
    """Dense rows as float32 on ``device``; a tensor keeps its device."""
    if isinstance(X, torch.Tensor):
        return X.to(default_dtype)
    return torch.as_tensor(np.asarray(X), dtype=default_dtype, device=device)


class NaiveBayesModel(Transformer):
    def __init__(self, log_prior, log_likelihood, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("log_prior", torch.as_tensor(log_prior, dtype=default_dtype, device=device))
        self.register_buffer(
            "log_likelihood", torch.as_tensor(log_likelihood, dtype=default_dtype, device=device)
        )

    def apply_batch(self, X):
        device = self.log_prior.device
        if isinstance(X, SparseBatch):
            return X.to_torch(device) @ self.log_likelihood.T + self.log_prior
        return as_rows(X, device) @ self.log_likelihood.T + self.log_prior


class NaiveBayesEstimator(LabelEstimator):
    """fit(term-frequency features, int labels) with Laplace smoothing."""

    def __init__(self, num_classes: int, smoothing: float = 1.0, device=None):
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.device = device

    def fit(self, data, labels) -> NaiveBayesModel:
        k = self.num_classes
        y = host_labels(labels)
        if y.size and (y.min() < 0 or y.max() >= k):
            raise ValueError(f"labels must lie in [0, {k}); got range [{y.min()}, {y.max()}]")
        if isinstance(data, SparseBatch):
            device = resolve_device(self.device)
            class_counts = torch.as_tensor(np.bincount(y, minlength=k), dtype=default_dtype, device=device)
            feature_counts = torch.as_tensor(data.grouped_column_sums(y, k), device=device)
        else:
            X = as_input(data, self.device)
            device = X.device
            onehot = torch.nn.functional.one_hot(torch.as_tensor(y, device=device), k).to(X.dtype)
            class_counts = onehot.sum(dim=0)
            feature_counts = onehot.T @ X
        log_prior = torch.log(class_counts) - torch.log(class_counts.sum())
        smoothed = feature_counts + self.smoothing
        log_likelihood = torch.log(smoothed) - torch.log(smoothed.sum(dim=1, keepdim=True))
        return NaiveBayesModel(log_prior, log_likelihood, device=device)
