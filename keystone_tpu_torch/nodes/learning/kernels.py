"""Pairwise squared distances and kernel generators (counterpart of
keystone_tpu/nodes/learning/kernels.py). A generator gives kernel blocks
k(X, Z) on demand, on the device of its operands: the n×n kernel matrix
is never held whole."""

from __future__ import annotations

import torch


def pairwise_sq_dists(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """||x − z||² for all pairs, in the expanded gemm-shaped form, clamped
    at 0 against cancellation. The one definition every kernel and both CG
    variants of ``kernel_ridge.py`` use."""
    # In place on the fresh product: a kernel block is the one large array
    # here. ``a − p`` is ``(−p) + a`` exactly, so the bits are those of
    # ``a − 2.0 * X @ Z.T + b``.
    sq = (2.0 * X) @ Z.T
    sq.neg_().add_((X * X).sum(dim=1, keepdim=True)).add_((Z * Z).sum(dim=1))
    return sq.clamp_min_(0.0)


class KernelGenerator:
    def block(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        """Kernel block k(X, Z) of shape (len(X), len(Z))."""
        raise NotImplementedError


class GaussianKernelGenerator(KernelGenerator):
    """k(x, z) = exp(−gamma ||x − z||²)."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def block(self, X, Z):
        # exp(−gamma · d²), in place on the distances.
        return pairwise_sq_dists(X, Z).mul_(-self.gamma).exp_()


class LinearKernelGenerator(KernelGenerator):
    def block(self, X, Z):
        return X @ Z.T
