"""Pairwise squared distances (counterpart of
keystone_tpu/nodes/learning/kernels.py::pairwise_sq_dists)."""

from __future__ import annotations

import torch


def pairwise_sq_dists(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """||x − z||² for all pairs, in the expanded gemm-shaped form, clamped
    at 0 against cancellation."""
    sq = (X * X).sum(dim=1, keepdim=True) - 2.0 * X @ Z.T + (Z * Z).sum(dim=1)
    return torch.clamp_min(sq, 0.0)
